"""Carry an ``LstmEncoder`` parameter tree from the JAX package across.

The flax tree, as numpy arrays, keeps the recurrent parameters under the same
names the port uses; only the heads differ: a flax ``Dense`` holds
``kernel (H, out)``, a torch ``Linear`` ``weight (out, H)``. R trees make a
``StackedLstmEncoder``'s state (``stacked_params_from_jax``), and
``replica_state`` takes replica r's solo state back out.
"""

from __future__ import annotations

import numpy as np
import torch

_HEADS = ("alpha_head", "beta_head")


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """State dict for the port's ``LstmEncoder`` from a flax param dict.

    ``tree`` maps ``w_ih_l{n}``/``w_hh_l{n}``/``b_ih_l{n}``/``b_hh_l{n}`` to
    arrays and each head to ``{"kernel", "bias"}``; any array type numpy can
    read works. The tensors are float32 copies on the CPU.
    """

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state: dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if name in _HEADS:
            state[f"{name}.weight"] = tensor(value["kernel"]).T.contiguous()
            state[f"{name}.bias"] = tensor(value["bias"])
        else:
            state[name] = tensor(value)
    return state


def stacked_params_from_jax(trees) -> dict[str, torch.Tensor]:
    """State dict for the port's ``StackedLstmEncoder`` from R flax param
    dicts, replica r from ``trees[r]``."""
    return {f"replicas.{r}.{name}": value
            for r, tree in enumerate(trees)
            for name, value in params_from_jax(tree).items()}


def replica_state(stacked_state, r: int) -> dict[str, torch.Tensor]:
    """Replica ``r``'s solo ``LstmEncoder`` state dict out of a
    ``StackedLstmEncoder``'s (CPU copies)."""
    prefix = f"replicas.{r}."
    return {name[len(prefix):]: value.detach().cpu().clone()
            for name, value in stacked_state.items() if name.startswith(prefix)}
