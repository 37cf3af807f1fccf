"""Multi-process parallelism on torch.distributed: process bring-up
(`multihost`) and the sharded products and solves (`sharded`)."""
