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
    """Training mode with dropout draws its masks (seeded by the generator)
    and raises on a wrong number of injected masks."""
    x = torch.randn((3, T, F), generator=torch.Generator().manual_seed(0))
    enc = LstmEncoder(hidden_size=H, num_layers=2, dropout=0.2, device="cpu")
    with pytest.raises(ValueError, match="take 1 masks, got 2"):
        enc(x, deterministic=False, masks=enc.draw_masks(T, 3) * 2)
    a = enc(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    b = enc(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a[0], enc(x)[0])
    # Without dropout, training mode computes the same deterministic forward.
    enc0 = LstmEncoder(hidden_size=H, num_layers=2, dropout=0.0, device="cpu")
    torch.testing.assert_close(enc0(x, deterministic=False), enc0(x))


@pytest.mark.parametrize("num_layers", [1, 2, 3, 4])
def test_dropout_masks_follow_torch_semantics(num_layers):
    """One mask per pair seam and per group boundary (none after the last
    layer), each {0, 1/(1-p)} with keep rate 1-p."""
    enc = LstmEncoder(hidden_size=H, num_layers=num_layers, dropout=0.25,
                      device="cpu")
    assert enc.n_masks == {1: 0, 2: 1, 3: 2, 4: 3}[num_layers]
    masks = enc.draw_masks(50, 40, torch.Generator().manual_seed(num_layers))
    for m in masks:
        assert m.shape == (50, 40, H)
        assert set(torch.unique(m).tolist()) <= {0.0, float(np.float32(1.0 / 0.75))}
        assert abs(float((m > 0).float().mean()) - 0.75) < 0.02


def test_training_forward_with_injected_masks_matches_jax(monkeypatch):
    """A 3-layer training forward with injected masks, its layers grouped as
    pair + single (the grouping at T=60, H=64, 100 rows; at this toy shape
    the rule would fuse all three, so the groups are set), against the JAX
    package's layer functions (interpret-mode Pallas pair with the seam
    mask, the boundary mask, the single layer) on the same weights."""
    import masters_thesis_tpu_torch.models.lstm as port_lstm
    from masters_thesis_tpu.ops.lstm_kernel import (
        lstm_pair_recurrence as jax_pair,
        lstm_recurrence as jax_recurrence,
    )

    _, params, port = _jax_pair(3, 1, seed=4)
    port.dropout = 0.2  # masks are used in training mode with dropout on
    monkeypatch.setattr(port, "layer_groups", lambda *a, **k: [2, 1])
    ran = []
    for name, depth in (("lstm_pair_recurrence", 2), ("lstm_recurrence", 1)):
        def spy(*a, _f=getattr(port_lstm, name), _d=depth, **k):
            ran.append(_d)
            return _f(*a, **k)
        monkeypatch.setattr(port_lstm, name, spy)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, T, F)).astype(np.float32)
    masks = [((rng.random((T, 6, H)) >= 0.2) / 0.8).astype(np.float32)
             for _ in range(2)]

    def proj(inputs, n):
        return (inputs @ params[f"w_ih_l{n}"].T
                + params[f"b_ih_l{n}"] + params[f"b_hh_l{n}"])

    h = jax_pair(
        proj(jnp.swapaxes(jnp.asarray(x), 0, 1), 0), params["w_hh_l0"].T,
        params["w_ih_l1"].T, params["b_ih_l1"] + params["b_hh_l1"],
        params["w_hh_l1"].T, mask=jnp.asarray(masks[0]), impl="interpret",
    ) * masks[1]
    h = jax_recurrence(proj(h, 2), params["w_hh_l2"].T, impl="interpret")[-1]
    want_a = h @ params["alpha_head"]["kernel"] + params["alpha_head"]["bias"]
    with torch.no_grad():
        got_a, _ = port(torch.from_numpy(x), deterministic=False,
                        masks=[torch.from_numpy(m) for m in masks])
    assert ran == [2, 1]
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL, rtol=0)


def test_model_registry():
    spec = get_model_spec("FinancialLstmNll", hidden_size=H)
    assert spec.objective == "nll" and spec.metric_keys == ("nll",)
    with pytest.raises(ValueError, match="Unknown module class"):
        get_model_spec("Nope")
