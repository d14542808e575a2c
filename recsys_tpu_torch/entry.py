"""The port's entry point: the item tower's forward on a tiny config.

Counterpart of ``entry()`` in the JAX package's ``__graft_entry__.py``: the
same config, ``CFG``, which ``dryrun.py`` shares as there (64 items, 32
users, 30 days, seed 0; field and name tokens 8, a 1024-word text
vocabulary; the default item tower), and the same batch (the first 16 items
of the seeded world). ``entry()`` returns ``(forward, args)``
with ``args = (model, std, re_ids, re_mask, txt_ids, txt_mask)``: the model
in the place of the JAX function's parameter tree, so that
``forward(*args)`` is the projector's output without dropout, (16, 128).

    python -m recsys_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from recsys_tpu_torch.config import Config, DataConfig, ItemTowerConfig, SimCSEConfig, VocabConfig
from recsys_tpu_torch.device import resolve_device

CFG = Config(
    data=DataConfig(num_items=64, num_users=32, days=30, seed=0),
    vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=1024),
    item_tower=ItemTowerConfig(),
    simcse=SimCSEConfig(batch_size=16),
)
INPUTS = ("std", "re_ids", "re_mask", "txt_ids", "txt_mask")


def _item_batch(n: int) -> tuple[dict, dict]:
    from recsys_tpu_torch.data.dataset import slice_item_batch, tokenize_items
    from recsys_tpu_torch.data.synthetic import generate_dataset
    from recsys_tpu_torch.data.vocab import StdVocab

    items, _, _ = generate_dataset(CFG.data)
    tensors = tokenize_items(items, StdVocab(), CFG.vocab)
    return tensors, slice_item_batch(tensors, np.arange(n))


def entry(device: torch.device | str = "cuda"):
    """(forward, args): the item tower's deterministic forward and its inputs
    on ``device`` (the card unless the caller asks for the CPU)."""
    from recsys_tpu_torch.data.vocab import StdVocab
    from recsys_tpu_torch.train.simcse import build_model

    device = resolve_device(device)
    tensors, batch = _item_batch(CFG.simcse.batch_size)
    model = build_model(CFG, StdVocab().size, tensors["std"].shape[1], device, seed=0)

    @torch.no_grad()
    def forward(model, std, re_ids, re_mask, txt_ids, txt_mask):
        model.eval()
        return model(std, re_ids, re_mask, txt_ids, txt_mask)

    return forward, (model, *(torch.as_tensor(batch[k], device=device) for k in INPUTS))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    fn, args = entry(parser.parse_args().device)
    print("entry ok:", tuple(fn(*args).shape))
