"""Hand-written CUDA kernels for the CoDA training, scoring and prefill
paths:

  * auc_loss        — the paper's fused min-max objective + closed-form grads
  * prox_update     — CoDA's fused proximal local update
  * opt_update      — the stateful optimizers' fused step (momentum with
                      stochastically rounded bf16 buffers, SM3's precond step)
  * flash_attention — GQA attention with causal / sliding-window masks (K4)

Each has a plain PyTorch version in ``ref.py`` and a dispatcher in
``ops.py``; the CUDA sources are ``csrc/coda_kernels.cu`` and
``csrc/flash_attention.cu`` (built by ``_build.py`` at first launch, never
at import).
"""
from repro_torch.kernels import ops, ref  # noqa: F401
