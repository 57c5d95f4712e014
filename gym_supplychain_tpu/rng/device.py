"""On-device episode-table generation — fast mode.

Generates the same demand processes and Poisson lead-time tables as the host
parity generator (rng/host.py) but with ``jax.random`` Threefry streams, fully
on device and batched over envs.  Streams are NOT bit-compatible with the
reference's MT19937 (documented trade-off; parity mode exists for that).
Used by the vectorized env for cheap batched auto-resets inside jit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.compile import CompiledChain, DemandConfig

__all__ = ["device_demand_tables", "device_leadtime_tables",
           "device_episode_tables", "poisson_clip_thresholds",
           "stateless_leadtime_row", "stateless_demand_row",
           "stateless_step_rows"]


def _one_demand(key, cfg: DemandConfig, T: int, R: int, B: int, dtype):
    """Demand table [T+1, R, B] for one product config (mirrors
    demands_generator.py:33-89 semantics)."""
    shape = (T + 1, R, B)
    if cfg.sen_peaks is None and cfg.std is None:
        d = jax.random.randint(key, shape, cfg.minv, cfg.maxv + 1)
        return d.astype(dtype)
    if cfg.sen_peaks is None:
        d = jax.random.normal(key, shape) * cfg.std + (cfg.maxv + cfg.minv) / 2
        return jnp.rint(jnp.clip(d, cfg.minv, cfg.maxv)).astype(dtype)
    std = 0.0 if cfg.std is None else cfg.std
    if cfg.perturb_norm:
        perturb = jax.random.normal(key, shape) * std
    else:
        perturb = jax.random.randint(key, shape, int(-3 * std),
                                     int(3 * std) + 1).astype(jnp.float32)
    periods = jnp.arange(T + 1)[:, None, None]
    half = (cfg.maxavg - cfg.minavg) / 2
    base = cfg.minavg + half * (1 + jnp.sin(cfg.sen_peaks * 2 * jnp.pi
                                            * periods / T))
    return jnp.rint(jnp.clip(base + perturb, cfg.minv, cfg.maxv)).astype(dtype)


def device_demand_tables(key, cc: CompiledChain, B: int, dtype=jnp.float32):
    """Demands [T+1, R, P, B] on device."""
    if not cc.demand_by_product:
        keys = [key] * cc.P if cc.P == 1 else list(jax.random.split(key, cc.P))
    else:
        keys = list(jax.random.split(key, cc.P))
    cols = []
    for p in range(cc.P):
        cfg = cc.demand[p if cc.demand_by_product else 0]
        cols.append(_one_demand(keys[p], cfg, cc.T, cc.R, B, dtype))
    return jnp.stack(cols, axis=2)


def device_leadtime_tables(key, cc: CompiledChain, B: int):
    """Poisson lead-times [T, K, B] int32: clip(1 + poisson(avg-1), 1, max)
    (supplychain_env.py:664-672)."""
    lt = 1 + jax.random.poisson(key, cc.Lavg - 1, (cc.T, cc.K, B))
    return jnp.clip(lt, 1, cc.Lmax).astype(jnp.int32)


def device_episode_tables(key, cc: CompiledChain, B: int, dtype=jnp.float32):
    kd, kl = jax.random.split(key)
    demands = device_demand_tables(kd, cc, B, dtype)
    leadtimes = device_leadtime_tables(kl, cc, B) if cc.stochastic_leadtimes else None
    return demands, leadtimes


# ---------------------------------------------------------------------------
# Stateless per-step draws (table-free fast mode)
#
# Carrying whole-episode tables through a ``lax.scan`` costs memory traffic
# (the [T+1,R,P,B] demand table rides the scan carry) and the [T,K,B]
# Poisson table has to be regenerated at every auto-reset
# (jax.random.poisson is a rejection sampler).  Counter-based Threefry gives
# random access to the stream, so the fast device path draws each step's
# rows directly from ``fold_in(episode_key, t)`` — no tables in the state at
# all — and samples the clipped lead-time distribution by inverse CDF with
# precomputed thresholds (exact: clip(1+Poisson(lam), 1, Lmax) has Lmax
# outcomes, so Lmax-1 CDF constants fully describe it).
# ---------------------------------------------------------------------------

def poisson_clip_thresholds(lam: float, lmax: int) -> np.ndarray:
    """CDF thresholds for sampling clip(1 + Poisson(lam), 1, Lmax).

    Returns ``cdf[j] = P(X <= j)`` for j = 0..Lmax-2; a uniform u maps to
    lead-time ``1 + sum_j(u >= cdf[j])`` which equals Lmax for the whole
    clipped tail.
    """
    if lmax <= 1:
        return np.zeros((0,), np.float32)
    pmf = np.zeros(lmax - 1, np.float64)
    pmf[0] = np.exp(-lam)
    for k in range(1, lmax - 1):
        pmf[k] = pmf[k - 1] * lam / k
    return np.cumsum(pmf).astype(np.float32)


def stateless_leadtime_row(key, cc: CompiledChain, B: int):
    """One step's lead-time row [K, B] (parity of distribution, not stream,
    with the reference's clip(1 + poisson(avg-1), 1, max); :664-672)."""
    cdf = poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax)
    u = jax.random.uniform(key, (cc.K, B))
    lt = jnp.ones((cc.K, B), jnp.int32)
    for j in range(cdf.shape[0]):
        lt = lt + (u >= cdf[j])
    return lt


def _one_demand_row(key, cfg: DemandConfig, t, T: int, R: int, B: int, dtype):
    """One period's demand row [R, B] for one product config (the single-row
    analogue of ``_one_demand``; ``t`` may be traced)."""
    shape = (R, B)
    if cfg.sen_peaks is None and cfg.std is None:
        return jax.random.randint(key, shape, cfg.minv, cfg.maxv + 1).astype(dtype)
    if cfg.sen_peaks is None:
        d = jax.random.normal(key, shape) * cfg.std + (cfg.maxv + cfg.minv) / 2
        return jnp.rint(jnp.clip(d, cfg.minv, cfg.maxv)).astype(dtype)
    std = 0.0 if cfg.std is None else cfg.std
    if cfg.perturb_norm:
        perturb = jax.random.normal(key, shape) * std
    else:
        perturb = jax.random.randint(key, shape, int(-3 * std),
                                     int(3 * std) + 1).astype(jnp.float32)
    half = (cfg.maxavg - cfg.minavg) / 2
    base = cfg.minavg + half * (1 + jnp.sin(cfg.sen_peaks * 2 * jnp.pi * t / T))
    return jnp.rint(jnp.clip(base + perturb, cfg.minv, cfg.maxv)).astype(dtype)


def stateless_demand_row(key, cc: CompiledChain, t, B: int, dtype=jnp.float32):
    """Demand row [R, P, B] for period ``t`` (traced), one draw per product."""
    keys = jax.random.split(key, cc.P) if cc.P > 1 else [key]
    cols = []
    for p in range(cc.P):
        cfg = cc.demand[p if cc.demand_by_product else 0]
        cols.append(_one_demand_row(keys[p], cfg, t, cc.T, cc.R, B, dtype))
    return jnp.stack(cols, axis=1)


def _demand_from_uniform(u, cfg: DemandConfig, t, T: int, dtype):
    """Transform uniforms [R, B] into one period's demand row (inverse-CDF
    versions of demands_generator.py:33-89; distribution parity, not stream).

    The uniform-int paths use floor(u * n) + lo, whose modulo bias is
    O(n * 2^-24) — negligible for the reference's demand ranges."""
    from jax.scipy.special import ndtri
    if cfg.sen_peaks is None and cfg.std is None:
        n = cfg.maxv - cfg.minv + 1
        return (jnp.floor(u * n) + cfg.minv).astype(dtype)
    if cfg.sen_peaks is None:
        d = ndtri(u) * cfg.std + (cfg.maxv + cfg.minv) / 2
        return jnp.rint(jnp.clip(d, cfg.minv, cfg.maxv)).astype(dtype)
    std = 0.0 if cfg.std is None else cfg.std
    if cfg.perturb_norm:
        perturb = ndtri(u) * std
    else:
        lo, hi = int(-3 * std), int(3 * std)
        perturb = jnp.floor(u * (hi - lo + 1)) + lo
    half = (cfg.maxavg - cfg.minavg) / 2
    base = cfg.minavg + half * (1 + jnp.sin(cfg.sen_peaks * 2 * jnp.pi * t / T))
    return jnp.rint(jnp.clip(base + perturb, cfg.minv, cfg.maxv)).astype(dtype)


def stateless_step_rows(ep_key, t, cc: CompiledChain, B: int,
                        dtype=jnp.float32):
    """All of one step's stochastic inputs from ONE fused uniform draw.

    Returns ``(demand_row [R,P,B] for period t, leadtime_row [K,B] or None)``.
    A single ``fold_in`` + uniform block per step keeps the Threefry cost to
    one batched invocation instead of five (each separate jax.random call
    costs its own fusion inside the scan body).
    """
    K = cc.K if cc.stochastic_leadtimes else 0
    rows = K + cc.R * cc.P
    u = jax.random.uniform(jax.random.fold_in(ep_key, t), (rows, B))
    lt_row = None
    if cc.stochastic_leadtimes:
        cdf = poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax)
        lt = jnp.ones((K, B), jnp.int32)
        for j in range(cdf.shape[0]):
            lt = lt + (u[:K] >= cdf[j])
        lt_row = lt
    ud = u[K:].reshape(cc.R, cc.P, B)
    cols = []
    for p in range(cc.P):
        cfg = cc.demand[p if cc.demand_by_product else 0]
        cols.append(_demand_from_uniform(ud[:, p], cfg, t, cc.T, dtype))
    return jnp.stack(cols, axis=1), lt_row
