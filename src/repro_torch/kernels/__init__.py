"""Hand-written CUDA kernels for the CoDA training, scoring, prefill and
serving paths:

  * auc_loss        — the paper's fused min-max objective + closed-form grads
  * prox_update     — CoDA's fused proximal local update
  * opt_update      — the stateful optimizers' fused step (momentum with
                      stochastically rounded bf16 buffers, SM3's precond step)
  * flash_attention — GQA attention with causal / sliding-window masks (K4)
  * grouped_matmul  — the ragged grouped GEMM of the sorted MoE dispatch (K5)

Each has a plain PyTorch version in ``ref.py`` and a dispatcher in
``ops.py``; the CUDA sources are ``csrc/coda_kernels.cu``,
``csrc/flash_attention.cu`` and ``csrc/moe_dispatch.cu`` (built by
``_build.py`` at first launch, never at import).
"""
from repro_torch.kernels import ops, ref  # noqa: F401
