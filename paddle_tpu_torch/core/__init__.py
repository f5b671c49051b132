"""Device resolution, dtypes and the kernel build."""
