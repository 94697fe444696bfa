"""PyTorch port of spiral_tpu: the Spiral PIR client and server on torch
tensors, with the server's hot loops as hand-written CUDA kernels for
Hopper (``spiral_tpu_torch/csrc``).

Residues are int32 tensors shaped (..., 2, d) holding (x mod P_I, x mod
B_I), both below 2^28; plain arithmetic widens to int64.  NTT-domain data
uses the slot order of the JAX package's ``mxu`` engine, so queries,
public params and databases cross between the two packages unchanged.
"""
