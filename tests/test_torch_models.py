"""The port's LstmEncoder and forward_rows against the JAX package's.

The JAX encoder runs its Pallas kernels in interpret mode, deterministic;
the port's encoder loads the same weights through ``params_from_jax`` and
runs on the CPU (plain recurrences). Tolerance 1e-5 abs: f32 on both sides,
summed in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.lstm import LstmEncoder as JaxEncoder
from masters_thesis_tpu.train.steps import forward_rows as jax_forward_rows
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.lstm import LstmEncoder
from masters_thesis_tpu_torch.models.objectives import get_model_spec
from masters_thesis_tpu_torch.train.steps import forward_rows

ATOL = 1e-5
H, T, F = 16, 8, 3


def _jax_pair(num_layers, n_factors, seed=0):
    module = JaxEncoder(
        hidden_size=H, num_layers=num_layers, dropout=0.0,
        n_factors=n_factors, kernel_impl="interpret",
    )
    params = module.init(
        jax.random.key(seed), jnp.zeros((1, T, F), jnp.float32)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = LstmEncoder(
        input_size=F, hidden_size=H, num_layers=num_layers, dropout=0.0,
        n_factors=n_factors, device="cpu",
    )
    port.load_state_dict(params_from_jax(params))
    return module, params, port


@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("n_factors", [1, 3])
def test_encoder_matches_jax(num_layers, n_factors):
    module, params, port = _jax_pair(num_layers, n_factors, seed=num_layers)
    x = np.random.default_rng(num_layers).normal(size=(11, T, F)).astype(np.float32)
    want_a, want_b = module.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got_a, got_b = port(torch.from_numpy(x))
    assert got_a.shape == (11, 1) and got_b.shape == (11, n_factors)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=ATOL, rtol=0)


def test_forward_rows_matches_jax():
    module, params, port = _jax_pair(2, 1)
    x = np.random.default_rng(5).normal(size=(2, 5, T, F)).astype(np.float32)
    want_a, want_b = jax_forward_rows(module, params, jnp.asarray(x))
    with torch.inference_mode():
        got_a, got_b = forward_rows(port, torch.from_numpy(x))
    assert got_a.shape == (2, 5, 1) and got_b.shape == (2, 5, 1)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=ATOL, rtol=0)


def test_converted_state_has_the_flax_names_and_shapes():
    _, params, port = _jax_pair(3, 2)
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict())
    for name, value in params.items():
        if name.endswith("_head"):
            assert state[f"{name}.weight"].shape == value["kernel"].T.shape
        else:
            assert tuple(state[name].shape) == value.shape


def test_init_is_seeded_and_torch_scaled():
    def build(seed):
        return LstmEncoder(
            hidden_size=H, num_layers=2, device="cpu",
            generator=torch.Generator().manual_seed(seed),
        ).state_dict()

    a, b, c = build(0), build(0), build(1)
    bound = 1.0 / np.sqrt(H)
    for name in a:
        assert torch.equal(a[name], b[name])
        assert float(a[name].abs().max()) <= bound
    assert not torch.equal(a["w_hh_l0"], c["w_hh_l0"])


def test_training_mode_dropout_raises():
    x = torch.zeros((3, T, F))
    enc = LstmEncoder(hidden_size=H, num_layers=2, dropout=0.2, device="cpu")
    with pytest.raises(NotImplementedError, match="training slice"):
        enc(x, deterministic=False)
    # Without dropout, training mode computes the same deterministic forward.
    enc0 = LstmEncoder(hidden_size=H, num_layers=2, dropout=0.0, device="cpu")
    torch.testing.assert_close(enc0(x, deterministic=False), enc0(x))


def test_model_registry():
    spec = get_model_spec("FinancialLstmNll", hidden_size=H)
    assert spec.objective == "nll" and spec.metric_keys == ("nll",)
    with pytest.raises(ValueError, match="Unknown module class"):
        get_model_spec("Nope")
