"""Frozen work counts: what one launch or one frame needs of the device, in
bytes and fp32 operations, from shapes and the live counts of the data."""
