"""Host-side data: batch assembly and the wire formats, the threaded
loader, the synthetic oracle clips and videos, and the UCF101-24 and AVA
readers with their augmentations and native JPEG loader."""
