"""JAX's threefry key chain in torch: the reference's random numbers, bit
for bit.

The reference draws its RANSAC scores with ``jax.random``: one key per
engine (``jax.random.key(seed)``), one ``split`` per frame, one
``uniform`` draw of the frame's subkey. This module reproduces that chain
as ``jax.random`` 0.9.0 computes it with ``jax_threefry_partitionable=True``
(its default), so a port Engine with seed s draws the hypotheses of a JAX
Engine with seed s:

- ``threefry2x32``: the Threefry-2x32 block cipher, 20 rounds (JAX's
  ``threefry2x32`` primitive);
- ``key(seed)``: JAX's ``threefry_seed``, the seed's high and low 32-bit
  words;
- ``split(key, n)``: the partitionable ("fold-like") split, key i the
  cipher of the counter (0, i);
- ``fold_in(key, data)``: the cipher of (0, data);
- ``uniform(key, shape, dtype)``: ``jax.random.uniform`` on [0, 1): the
  partitionable bits of counter i, the flat index of the element in
  ``shape``, are the cipher of (i >> 32, i & 0xFFFFFFFF); float32 takes
  the top 23 bits of ``bits1 ^ bits2``, float64 the top 52 of
  ``bits1 << 32 | bits2``, as the mantissa of a float in [1, 2), minus 1.

So a draw's leading rows are a smaller draw of the same key: REVE's
[3, n] scores are the first rows of the floor detector's [128, n].

A key is a pair of Python ints (its two 32-bit words), never a JAX key.
Words are held in Python ints or int64 tensors and masked to 32 bits: no op
needs an unsigned type. The key chain is a handful of words and stays on
the host; ``uniform`` computes its counters on the device it is given, with
integer ops and one exact conversion, so a draw on the card equals the
CPU's bit for bit.

Which float type JAX draws follows ``jax_enable_x64`` (float64 when it is
on, whatever the engine's dtype); ``uniform`` draws the ``dtype`` it is
given, so a float32 port Engine draws what a JAX Engine draws with x64 off.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple[int, int]


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the key
    words (k0, k1): each a Python int or an int64 tensor of 32-bit words,
    broadcast together. Returns the two output words, masked to 32 bits.

    x0 is masked only at the end: its low 32 bits are all that the adds and
    xors read, and its high bits stay well inside int64. x1 is masked
    before every rotation, whose right shift reads bits 32 and up."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & MASK
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & MASK
    return x0 & MASK, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s words: the high and the low 32 bits of the
    64-bit seed."""
    seed = int(seed)
    if not -(2**63) <= seed < 2**63:
        raise ValueError(f"a seed is a 64-bit integer, got {seed}")
    return (seed >> 32) & MASK, seed & MASK


def split(key: Key, n: int = 2) -> tuple[Key, ...]:
    """``jax.random.split(key, n)``: key i is the cipher of (0, i)."""
    return tuple(threefry2x32(key[0], key[1], 0, i) for i in range(n))


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit unsigned ``data``."""
    if not 0 <= data <= MASK:
        raise ValueError(f"fold_in takes a 32-bit unsigned integer, got {data}")
    return threefry2x32(key[0], key[1], 0, data)


def uniform_stack(keys, shape: tuple[int, ...], dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape, dtype)`` for each key k of ``keys``,
    stacked: [len(keys), *shape], computed on ``device``. ``keys``: a list
    of keys, or their words as an int64 tensor [K, 2] on ``device``."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"uniform draws float32 or float64, got {dtype}")
    n = math.prod(shape)
    if isinstance(keys, torch.Tensor):
        k0, k1 = keys[:, :1], keys[:, 1:]
    elif len(keys) == 1:  # one key: its words enter the ops as scalars, with no copy
        k0, k1 = keys[0]
    else:
        words = torch.tensor(list(keys), dtype=torch.int64, device=device)
        k0, k1 = words[:, :1], words[:, 1:]
    counter = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k0, k1, counter >> 32, counter & MASK)
    if dtype == torch.float32:
        mantissa = ((b0 ^ b1) >> 9) | 0x3F800000
        floats = mantissa.to(torch.int32).view(torch.float32)
    else:
        mantissa = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        floats = mantissa.view(torch.float64)
    floats = torch.clamp_min(floats - 1.0, 0.0)  # JAX's max(minval, .) with minval 0
    return floats.reshape(len(keys), *shape)


def uniform(key: Key, shape: tuple[int, ...], dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1), computed on
    ``device``."""
    return uniform_stack([key], shape, dtype, device)[0]
