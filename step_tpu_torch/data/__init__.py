"""Host-side data: batch assembly and the wire formats, the threaded
loader, the synthetic oracle clips and videos, and the UCF101-24 reader
with its augmentations and native JPEG loader."""
