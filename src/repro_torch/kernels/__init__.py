"""Hand-written CUDA kernels for the CoDA main path:

  * auc_loss    — the paper's fused min-max objective + closed-form grads
  * prox_update — CoDA's fused proximal local update
  * opt_update  — the stateful optimizers' fused step (momentum with
                  stochastically rounded bf16 buffers, SM3's precond step)

Each has a plain PyTorch version in ``ref.py`` and a dispatcher in
``ops.py``; the CUDA source is ``csrc/coda_kernels.cu`` (built by
``_build.py`` at first launch, never at import).
"""
from repro_torch.kernels import ops, ref  # noqa: F401
