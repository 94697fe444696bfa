"""Scale-out of the server over torch.distributed (counterpart of
spiral_tpu/dist/): shard.py, multihost.py."""
