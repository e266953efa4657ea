"""Replays the JAX package's NUTS key stream into the port's noise source.

``amf_tpu.mcmc.nuts`` draws from ``jax.random`` keys; the port draws from a
``NUTSNoise``. This helper walks the JAX sampler's splits in its order and
hands the port the very draws the JAX sampler makes, so the two samplers
can be held to each other draw for draw:

* ``nuts_kernel``: ``kmom, key = split(key)``; per depth
  ``key, kdir, ksub, kmerge = split(key, 4)`` with ``bernoulli(kdir)`` and
  ``uniform(kmerge)``; per leaf of the depth's subtree
  ``k, ksel = split(k)`` from ``ksub`` and ``uniform(ksel)``;
* ``run_nuts``: ``kf, key = split(key)`` (only without an eps anchor),
  then ``key, kstep, kfind = split(key, 3)`` per warm step and
  ``key, kstep, kjit = split(key, 3)`` per draw.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from amf_tpu_torch.mcmc.nuts import NUTSNoise, StepNoise


@functools.lru_cache(maxsize=None)
def _transition_fn(dim: int, max_depth: int, dtype_name: str):
    dtype = jnp.dtype(dtype_name)

    def draws(kstep):
        kmom, key = jax.random.split(kstep)
        z = jax.random.normal(kmom, (dim,), dtype=dtype)

        def depth(key, _):
            key, kdir, ksub, kmerge = jax.random.split(key, 4)
            return key, (jax.random.bernoulli(kdir),
                         jax.random.uniform(kmerge, dtype=dtype), ksub)

        def leaf(k, _):
            k, ksel = jax.random.split(k)
            return k, jax.random.uniform(ksel, dtype=dtype)

        _, (go, um, ksub) = jax.lax.scan(depth, key, None, length=max_depth)
        # every depth's chain of leaf keys, as long as the deepest needs
        chains = jax.vmap(lambda k: jax.lax.scan(
            leaf, k, None, length=2 ** (max_depth - 1))[1])(ksub)
        leaves = jnp.concatenate([chains[j, :2 ** j]
                                  for j in range(max_depth)])
        return z, go, um, leaves

    return jax.jit(jax.vmap(jax.vmap(draws)))


@functools.lru_cache(maxsize=None)
def _normal_fn(dim: int, dtype_name: str):
    dtype = jnp.dtype(dtype_name)
    return jax.jit(jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (dim,), dtype=dtype))))


@functools.lru_cache(maxsize=None)
def _uniform_fn(dtype_name: str):
    dtype = jnp.dtype(dtype_name)
    return jax.jit(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, dtype=dtype))))


@functools.lru_cache(maxsize=None)
def _walk_fn(T: int):
    def walk(key):
        def body(key, _):
            key, kstep, kx = jax.random.split(key, 3)
            return key, (kstep, kx)

        return jax.lax.scan(body, key, None, length=T)[1]

    return jax.jit(jax.vmap(walk))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def search_momentum(keys, dim: int, dtype=torch.float64) -> torch.Tensor:
    """The momentum ``find_reasonable_step_size(key, ...)`` draws, per lane."""
    fn = _normal_fn(dim, str(dtype).split(".")[-1])
    return _t(fn(jnp.asarray(keys)[:, None])[:, 0], dtype)


def transition_noise(kstep, dim: int, max_depth: int,
                     dtype=torch.float64) -> StepNoise:
    """The draws ``nuts_kernel`` makes from keys kstep (L, 2), per lane."""
    fn = _transition_fn(dim, max_depth, str(dtype).split(".")[-1])
    z, go, um, leaves = fn(jnp.asarray(kstep)[:, None])
    L = z.shape[0]
    return StepNoise(momentum=_t(z[:, 0], dtype), go_right=_t(go[:, 0]),
                     u_merge=_t(um[:, 0], dtype), u_leaf=_t(leaves[:, 0], dtype),
                     u_jitter=torch.zeros(L, dtype=dtype))


class ReplayNoise(NUTSNoise):
    """The draws of ``run_nuts`` under JAX keys (L, 2), one key a lane."""

    def __init__(self, keys, dim: int, max_depth: int, warmup: int,
                 num_samples: int, with_search: bool = True,
                 dtype=torch.float64):
        keys = jnp.asarray(keys)
        name = str(dtype).split(".")[-1]
        self.warmup = warmup
        self.search0 = None
        if with_search:
            kf_key = jax.vmap(jax.random.split)(keys)
            kf, keys = kf_key[:, 0], kf_key[:, 1]
            self.search0 = _t(_normal_fn(dim, name)(kf[:, None])[:, 0], dtype)
        T = warmup + num_samples
        if T:
            kstep, kx = _walk_fn(T)(keys)  # (L, T, 2) each
            z, go, um, leaves = _transition_fn(dim, max_depth, name)(kstep)
            self.z, self.go = _t(z, dtype), _t(go)
            self.um, self.leaves = _t(um, dtype), _t(leaves, dtype)
            self.find = _t(_normal_fn(dim, name)(kx[:, :warmup]), dtype) \
                if warmup else None
            self.jit = _t(_uniform_fn(name)(kx), dtype)

    def step(self, t: int) -> StepNoise:
        return StepNoise(momentum=self.z[:, t], go_right=self.go[:, t],
                         u_merge=self.um[:, t], u_leaf=self.leaves[:, t],
                         u_jitter=self.jit[:, t])

    def search(self, t):
        return self.search0 if t is None else self.find[:, t]
