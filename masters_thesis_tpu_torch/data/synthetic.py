"""Synthetic single-factor and K-factor log-return data-generating processes.

A copy of the numpy DGP in ``masters_thesis_tpu/data/synthetic.py`` (the
port imports nothing of the JAX package): daily log returns (in percent) for
``n_stocks`` driven by one market factor,

    r_stock[i, t] = alpha[i] + beta[i] * r_market[t] + eps[i, t]

with Student-t market and idiosyncratic shocks and Normal alpha/beta, using
the same distribution parameters (estimated from the 25-Portfolios dataset,
"no outliers" variant). Sampling is numpy under an explicit seed, so the same
seed gives the same arrays, bit for bit, in both packages.
"""

from __future__ import annotations

import numpy as np


class SyntheticLogReturns:
    """Single-factor DGP with heavy-tailed shocks.

    Returned arrays (all float32):
        ``r_stocks``: ``(n_stocks, n_samples)``
        ``r_market``: ``(n_samples,)``
        ``alphas``:   ``(n_stocks,)``
        ``betas``:    ``(n_stocks,)``
    """

    # Parameters estimated from the 25_Portfolios dataset (no-outliers variant),
    # matching the reference constants (src/data.py:36-39).
    mkt_params = {"loc": 0.0678, "scale": 0.5099, "df": 5.0}  # Student-t
    idio_params = {"loc": 0.0000, "scale": 0.3140, "df": 5.0}  # Student-t
    alpha_params = {"loc": 0.0098, "scale": 0.1271}  # Normal
    beta_params = {"loc": 0.9444, "scale": 0.3521}  # Normal

    # Alternative estimate including outlier days (the reference keeps these
    # in a comment, src/data.py:41-47; here they are a selectable variant).
    mkt_params_outliers = {"loc": 0.0538, "scale": 0.6616, "df": 5.0}
    idio_params_outliers = {"loc": 0.0000, "scale": 0.3539, "df": 5.0}
    alpha_params_outliers = {"loc": 0.0056, "scale": 0.1501}
    beta_params_outliers = {"loc": 1.0046, "scale": 0.3785}

    @staticmethod
    def generate(
        n_stocks: int,
        n_samples: int,
        seed: int = 0,
        variant: str = "no_outliers",
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Sample one synthetic market history under an explicit seed.

        ``variant``: ``"no_outliers"`` (reference default) or ``"outliers"``
        (parameters estimated including outlier days).
        """
        rng = np.random.default_rng(seed)
        p = SyntheticLogReturns
        if variant == "no_outliers":
            mkt, idio = p.mkt_params, p.idio_params
            alpha_p, beta_p = p.alpha_params, p.beta_params
        elif variant == "outliers":
            mkt, idio = p.mkt_params_outliers, p.idio_params_outliers
            alpha_p, beta_p = p.alpha_params_outliers, p.beta_params_outliers
        else:
            raise ValueError(f"unknown DGP variant: {variant!r}")

        def student_t(params, shape):
            return (
                params["loc"] + params["scale"] * rng.standard_t(params["df"], shape)
            ).astype(np.float32)

        r_market = student_t(mkt, (n_samples,))
        r_idio = student_t(idio, (n_stocks, n_samples))
        alphas = (
            alpha_p["loc"] + alpha_p["scale"] * rng.standard_normal(n_stocks)
        ).astype(np.float32)
        betas = (
            beta_p["loc"] + beta_p["scale"] * rng.standard_normal(n_stocks)
        ).astype(np.float32)

        r_systematic = alphas[:, None] + betas[:, None] * r_market[None, :]
        r_stocks = (r_systematic + r_idio).astype(np.float32)
        return r_stocks, r_market, alphas, betas


class SyntheticKFactorReturns:
    """K-factor DGP with heavy-tailed factor shocks.

    The universe-scale generalization of :class:`SyntheticLogReturns`:

        r_asset[i, t] = alpha[i] + Σ_k beta[i, k] * f[k, t] + eps[i, t]

    Factor 0 keeps the market's Student-t parameters; the remaining factors
    are zero-mean style factors with the same scale/tails. Loadings on the
    market keep the reference Normal cross-section; style loadings are
    zero-centered with the same dispersion. Idiosyncratic shocks and alphas
    are unchanged from the scalar DGP.

    Returned arrays (all float32):
        ``r_assets``: ``(n_assets, n_samples)``
        ``factors``:  ``(n_factors, n_samples)``
        ``alphas``:   ``(n_assets,)``
        ``betas``:    ``(n_assets, n_factors)``
    """

    @staticmethod
    def generate(
        n_assets: int,
        n_samples: int,
        n_factors: int = 1,
        seed: int = 0,
        variant: str = "no_outliers",
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Sample one synthetic K-factor history under an explicit seed."""
        if n_factors < 1:
            raise ValueError(f"n_factors must be >= 1, got {n_factors}")
        rng = np.random.default_rng(seed)
        p = SyntheticLogReturns
        if variant == "no_outliers":
            mkt, idio = p.mkt_params, p.idio_params
            alpha_p, beta_p = p.alpha_params, p.beta_params
        elif variant == "outliers":
            mkt, idio = p.mkt_params_outliers, p.idio_params_outliers
            alpha_p, beta_p = p.alpha_params_outliers, p.beta_params_outliers
        else:
            raise ValueError(f"unknown DGP variant: {variant!r}")

        def student_t(params, shape):
            return (
                params["loc"] + params["scale"] * rng.standard_t(params["df"], shape)
            ).astype(np.float32)

        factors = student_t(mkt, (n_factors, n_samples))
        if n_factors > 1:
            # Style factors: market tails and scale, but zero drift.
            factors[1:] -= np.float32(mkt["loc"])
        r_idio = student_t(idio, (n_assets, n_samples))
        alphas = (
            alpha_p["loc"] + alpha_p["scale"] * rng.standard_normal(n_assets)
        ).astype(np.float32)
        betas = (
            beta_p["scale"] * rng.standard_normal((n_assets, n_factors))
        ).astype(np.float32)
        betas[:, 0] += np.float32(beta_p["loc"])

        r_systematic = alphas[:, None] + betas @ factors
        r_assets = (r_systematic + r_idio).astype(np.float32)
        return r_assets, factors, alphas, betas
