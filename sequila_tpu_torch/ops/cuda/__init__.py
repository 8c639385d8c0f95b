"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes."""
