"""Op dispatch: every hot op has a plain PyTorch form and, where the JAX
package had a Pallas kernel, a hand-written CUDA twin.

The modes are the JAX package's ``kernel`` config values:

  * ``auto``   - the CUDA kernel for CUDA tensors, the plain form for CPU ones;
  * ``pallas`` - the hand kernel always; a CPU tensor raises;
  * ``xla``    - the plain PyTorch form always.
"""

from __future__ import annotations

import torch


def use_kernel(mode: str, device: torch.device | str) -> bool:
    """Whether ``mode`` sends a tensor on ``device`` through the hand kernel."""
    is_cuda = torch.device(device).type == "cuda"
    if mode == "pallas":
        if not is_cuda:
            raise RuntimeError("kernel mode 'pallas' needs CUDA tensors; "
                               f"got a tensor on {device}")
        return True
    if mode == "xla":
        return False
    if mode == "auto":
        return is_cuda
    raise ValueError(f"unknown kernel mode {mode!r} (auto | pallas | xla)")


def select_infonce(mode: str = "auto"):
    from recsys_tpu_torch.ops.contrastive import bidirectional_infonce
    from recsys_tpu_torch.ops.contrastive_kernel import fused_bidirectional_infonce

    def infonce(emb1, emb2, temperature: float = 0.08):
        fn = (fused_bidirectional_infonce if use_kernel(mode, emb1.device)
              else bidirectional_infonce)
        return fn(emb1, emb2, temperature)

    return infonce


def select_logq_loss(mode: str = "auto"):
    from recsys_tpu_torch.ops.contrastive import inbatch_logq_loss
    from recsys_tpu_torch.ops.contrastive_kernel import fused_inbatch_logq_loss

    def logq_loss(user_emb, item_emb, pos_item_ids, log_q, **kw):
        fn = (fused_inbatch_logq_loss if use_kernel(mode, user_emb.device)
              else inbatch_logq_loss)
        return fn(user_emb, item_emb, pos_item_ids, log_q, **kw)

    return logq_loss


def select_fm(mode: str = "auto"):
    """The FM second-order term (B, F, K) -> (B,) under ``mode``."""
    from recsys_tpu_torch.ops.fm import fm_interaction
    from recsys_tpu_torch.ops.fm_kernel import fused_fm_interaction

    def fm(v):
        return (fused_fm_interaction if use_kernel(mode, v.device) else fm_interaction)(v)

    return fm
