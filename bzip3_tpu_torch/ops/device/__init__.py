"""Device stages: BWT (tensor code) and the CM coder (plain PyTorch in
``cm``, hand-written CUDA kernels behind ``cm_cuda``)."""
