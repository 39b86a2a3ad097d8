"""Model specs: the hyperparameter bundle and the reference class registry.

Counterpart of ``ModelSpec``, ``MODEL_REGISTRY`` and ``get_model_spec`` in
``masters_thesis_tpu/models/objectives.py``. The window objectives come with
the training slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Hyperparameter bundle for one configured model + objective."""

    objective: str  # 'mse' | 'nll' | 'combined'
    input_size: int = 3
    hidden_size: int = 64
    num_layers: int = 2
    dropout: float = 0.2
    n_factors: int = 1  # loadings per row (beta head width)
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    mse_weight: float = 1e2

    def build_module(self, device=None, generator: torch.Generator | None = None):
        from masters_thesis_tpu_torch.models.lstm import LstmEncoder

        return LstmEncoder(
            input_size=self.input_size,
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            dropout=self.dropout,
            n_factors=self.n_factors,
            device=device,
            generator=generator,
        )

    @property
    def metric_keys(self) -> tuple:
        """Per-objective logged metric names."""
        return {
            "mse": ("mse",),
            "nll": ("nll",),
            "combined": ("mse", "nll"),
        }[self.objective]


# The reference's CLI class names.
MODEL_REGISTRY: dict[str, str] = {
    "FinancialLstmMse": "mse",
    "FinancialLstmNll": "nll",
    "FinancialLstmCombined": "combined",
}


def get_model_spec(module_class_name: str, **hparams) -> ModelSpec:
    """Map a reference-style class name to a configured ModelSpec."""
    if module_class_name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown module class: {module_class_name}. "
            f"Available: {list(MODEL_REGISTRY.keys())}"
        )
    return ModelSpec(objective=MODEL_REGISTRY[module_class_name], **hparams)
