"""Hand-written CUDA kernels for Hopper, the counterpart of
damvsnet_tpu/ops/pallas/. Each wrapper launches its kernel on a CUDA tensor
and runs its plain PyTorch version on a CPU tensor; nothing falls back."""
