"""PyTorch/CUDA port of tfmq_dm_tpu: the DDIM CIFAR-10 w4a8 int4-serving
slice, with packed-int4 CUDA kernels for Hopper (see README.md)."""
