"""The RGB-D frontend: FAST corners, LATCH descriptors, Hamming matching and
a RANSAC homography filter as PyTorch ops, the Kinect measurement source and
the TUM dataset converter (the torch twin of monorfs_tpu.frontend)."""
