"""Device kernels and their plain versions (rotated, chainback, plane),
the plain scans (torch_core, bigstate) and the tensor encoder."""
