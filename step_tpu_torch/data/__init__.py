"""Host-side data: batch assembly and the wire formats, the threaded
loader, and the synthetic oracle clips and videos."""
