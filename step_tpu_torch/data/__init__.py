"""Host-side data: the synthetic oracle videos and the uint8 wire format."""
