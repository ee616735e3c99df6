# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Port BEV pool (conch_tpu_torch.ops.vision, K13a/K13b's plain versions on
the CPU) against the JAX package's ``bev_pool`` / ``bev_pool_backward``
(Pallas in interpret mode for ``cells_sorted=True``, XLA otherwise).

The same seeded numpy inputs go to both, built as tests/vision_test.py
builds them (BEVFusion's intervals: contiguous points per cell, cells
ascending when sorted), and are held at that test's 1e-5. The gradient
through the port's autograd op is held against ``jax.grad`` and against
the explicit backward, and ``gradcheck`` runs in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conch_tpu.ops.vision as jv
from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_launcher, bev_pool_forward_launcher
from conch_tpu_torch.ops.vision import bev_pool, bev_pool_backward
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)


def _make_bev_inputs(rng, num_intervals=20, max_len=6, channels=16, b=2, gz=1, gx=8, gy=8, sort_cells=True):
    lengths = rng.integers(1, max_len + 1, size=num_intervals)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    n = int(lengths.sum())
    feats = rng.normal(size=(n, channels)).astype(np.float32)
    cells = rng.choice(b * gz * gx * gy, size=num_intervals, replace=False)
    if sort_cells:
        cells = np.sort(cells)
    geom = np.zeros((n, 4), dtype=np.int32)
    for i, (s, ln) in enumerate(zip(starts, lengths)):
        cell = cells[i]
        bb, zz = cell // (gz * gx * gy), (cell // (gx * gy)) % gz
        xx, yy = (cell // gy) % gx, cell % gy
        geom[s : s + ln] = (xx, yy, zz, bb)
    return feats, geom, starts, lengths.astype(np.int32), (b, gz, gx, gy)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _forward_both(feats, geom, starts, lengths, dims, sort_cells):
    launches = bev_pool_forward_launcher.launches
    out = bev_pool(*_torch(feats, geom, starts, lengths), *dims, cells_sorted=sort_cells)
    assert bev_pool_forward_launcher.launches == launches  # CPU tensors: the plain version, no launch
    ref = jv.bev_pool(*_jax(feats, geom, starts, lengths), *dims, cells_sorted=sort_cells)
    return out, np.asarray(ref)


@pytest.mark.parametrize("sort_cells", [True, False])
def test_bev_pool_forward_matches_jax(rng, sort_cells):
    feats, geom, starts, lengths, dims = _make_bev_inputs(rng, sort_cells=sort_cells)
    out, ref = _forward_both(feats, geom, starts, lengths, dims, sort_cells)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sort_cells", [True, False])
def test_bev_pool_forward_large_duplicate_cells(rng, sort_cells):
    """700 intervals (past the TPU kernels' window sizes), C = 24, and interval
    13 moved onto interval 14's cell: scatter-ADD of the two sums."""
    feats, geom, starts, lengths, dims = _make_bev_inputs(
        rng, num_intervals=700, max_len=9, channels=24, b=1, gz=1, gx=32, gy=32, sort_cells=sort_cells)
    geom[starts[13] : starts[13] + lengths[13]] = geom[starts[14]][None, :]
    out, ref = _forward_both(feats, geom, starts, lengths, dims, sort_cells)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sort_cells", [True, False])
def test_bev_pool_cell_outside_grid_is_dropped(rng, sort_cells):
    """The last interval's batch index is past the grid: both packages drop it
    in the forward; the sorted backward gives its points zero."""
    feats, geom, starts, lengths, dims = _make_bev_inputs(rng, num_intervals=12, sort_cells=True)
    s, ln = starts[-1], lengths[-1]
    geom[s : s + ln, 3] = dims[0]
    out, ref = _forward_both(feats, geom, starts, lengths, dims, sort_cells)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    grad = rng.normal(size=ref.shape).astype(np.float32)
    g = bev_pool_backward(*_torch(grad, geom, starts, lengths), cells_sorted=sort_cells).numpy()
    assert not g[s : s + ln].any()
    if sort_cells:  # the JAX XLA path clamps its gather instead (see kernels/vision/bev_pool.py)
        np.testing.assert_array_equal(g, np.asarray(jv.bev_pool_backward(*_jax(grad, geom, starts, lengths))))


@pytest.mark.parametrize("sort_cells", [True, False])
def test_bev_pool_backward_matches_jax(rng, sort_cells):
    feats, geom, starts, lengths, dims = _make_bev_inputs(rng, sort_cells=sort_cells)
    grad = rng.normal(size=(*dims, feats.shape[1])).astype(np.float32)
    launches = bev_pool_backward_launcher.launches
    g = bev_pool_backward(*_torch(grad, geom, starts, lengths), cells_sorted=sort_cells)
    assert bev_pool_backward_launcher.launches == launches
    ref = jv.bev_pool_backward(*_jax(grad, geom, starts, lengths), cells_sorted=sort_cells)
    assert g.dtype == torch.float32 and g.shape == (feats.shape[0], feats.shape[1])
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bev_pool_backward_gaps_are_zero(rng):
    """Points in no interval (a gap before, between and after the intervals)
    take a zero gradient, as in the JAX package."""
    feats, geom, starts, lengths, dims = _make_bev_inputs(rng, num_intervals=10)
    keep = np.ones(len(starts), bool)
    keep[[0, 4, 9]] = False  # drop three intervals: their points are in none
    starts, lengths = starts[keep], lengths[keep]
    grad = rng.normal(size=(*dims, feats.shape[1])).astype(np.float32)
    g = bev_pool_backward(*_torch(grad, geom, starts, lengths)).numpy()
    np.testing.assert_array_equal(g, np.asarray(jv.bev_pool_backward(*_jax(grad, geom, starts, lengths))))
    assert (np.abs(g).sum(axis=1) == 0).sum() == feats.shape[0] - lengths.sum()


@pytest.mark.parametrize("sort_cells", [True, False])
def test_bev_pool_autograd_matches_jax_grad(rng, sort_cells):
    feats, geom, starts, lengths, dims = _make_bev_inputs(rng, num_intervals=8, sort_cells=sort_cells)
    geom_t, starts_t, lengths_t = _torch(geom, starts, lengths)
    x = torch.from_numpy(feats).requires_grad_(True)
    out = bev_pool(x, geom_t, starts_t, lengths_t, *dims, cells_sorted=sort_cells)
    (g_auto,) = torch.autograd.grad((out**2).sum(), x)
    g_explicit = bev_pool_backward(2 * out.detach(), geom_t, starts_t, lengths_t, cells_sorted=sort_cells)
    np.testing.assert_allclose(g_auto.numpy(), g_explicit.numpy(), rtol=1e-5, atol=1e-5)

    def loss(f):
        return jnp.sum(jv.bev_pool(f, *_jax(geom, starts, lengths), *dims, cells_sorted=sort_cells) ** 2)

    g_jax = jax.grad(loss)(jnp.asarray(feats))
    np.testing.assert_allclose(g_auto.numpy(), np.asarray(g_jax), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sort_cells", [True, False])
def test_bev_pool_gradcheck_f64(rng, sort_cells):
    feats, geom, starts, lengths, dims = _make_bev_inputs(rng, num_intervals=6, max_len=3, channels=3, b=1, gx=4,
                                                          gy=4, sort_cells=sort_cells)
    x = torch.from_numpy(feats.astype(np.float64)).requires_grad_(True)
    geom_t, starts_t, lengths_t = _torch(geom, starts, lengths)
    assert torch.autograd.gradcheck(
        lambda f: bev_pool(f, geom_t, starts_t, lengths_t, *dims, cells_sorted=sort_cells), (x,))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_bev_pool_half_types_sum_in_f32(rng, dtype):
    """bf16 / f16 features sum in f32 and round once, as the TPU kernels do:
    equal to the f32 pool of the same values, cast."""
    feats, geom, starts, lengths, dims = _make_bev_inputs(rng, num_intervals=40, max_len=9, channels=10)
    x = torch.from_numpy(feats).to(dtype)
    rest = _torch(geom, starts, lengths)
    out = bev_pool(x, *rest, *dims)
    assert out.dtype == dtype
    torch.testing.assert_close(out, bev_pool(x.float(), *rest, *dims).to(dtype), rtol=0, atol=0)
    grad = torch.from_numpy(rng.normal(size=(*dims, 10)).astype(np.float32)).to(dtype)
    g = bev_pool_backward(grad, *rest)
    assert g.dtype == dtype
    torch.testing.assert_close(g, bev_pool_backward(grad.float(), *rest).to(dtype), rtol=0, atol=0)


def test_bev_pool_rejects_malformed_input(rng):
    feats, geom, starts, lengths, dims = _make_bev_inputs(rng, num_intervals=4)
    f, g, s, n = _torch(feats, geom, starts, lengths)
    with pytest.raises(ValueError, match="geom_feats"):
        bev_pool(f, g[:, :3], s, n, *dims)
    with pytest.raises(ValueError, match="interval_starts"):
        bev_pool(f, g, s, n[:-1], *dims)
    with pytest.raises(ValueError, match="floating-point"):
        bev_pool(f.to(torch.int32), g, s, n, *dims)
