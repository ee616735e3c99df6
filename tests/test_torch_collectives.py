# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The port's collectives layer (``conch_tpu_torch.parallel``, K14's plain
version on the CPU) against the JAX package's, on the 8 virtual CPU devices
of the JAX side (tests/conftest.py) and a ring of CPU ranks on the port's.

The same numpy shards go to both. ``ring_all_gather`` and K14's plain path
are held bit for bit against JAX's ``ring_all_gather`` (``shard_map`` over
``create_mesh(data=1, model=n)``) at n = 1, 2 and 8 and against the Pallas
ring kernel in interpret mode (``ring_all_gather_pallas``, simulated remote
copies and semaphores) at n = 8, every rank's result compared. The
collective matmuls are held at tests/collectives_test.py's shapes and
tolerance (f32, rtol = atol = 1e-4) and in bf16 at one bf16 step (both
sides sum in f32, in their own orders, before the one cast).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conch_tpu.parallel.collectives import overlapped_allgather_matmul as jax_allgather_matmul
from conch_tpu.parallel.collectives import overlapped_matmul_reduce_scatter as jax_matmul_reduce_scatter
from conch_tpu.parallel.collectives import ring_all_gather as jax_ring_all_gather
from conch_tpu.parallel.mesh import create_mesh as jax_create_mesh
from conch_tpu_torch.kernels.collectives import ring_all_gather as ring_module
from conch_tpu_torch.kernels.collectives.ring_all_gather import (
    check_ring_error,
    decode_ring_error,
    ring_all_gather_launcher,
    ring_all_gather_plain,
)
from conch_tpu_torch.parallel import (
    create_mesh,
    overlapped_allgather_matmul,
    overlapped_matmul_reduce_scatter,
    ppermute,
    ring_all_gather,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a) -> np.ndarray:
    """The raw bits of a JAX array or a torch tensor, for bit-for-bit checks."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _jax_per_rank(fn, x, n: int, in_specs, out_rows: int) -> list[np.ndarray]:
    """Run ``fn`` under ``shard_map`` over an n-device model axis and return
    each device's own output block."""
    mesh = jax_create_mesh(data=1, model=n)
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=P("model", None), check_vma=False))(x)
    return [_bits(out[r * out_rows : (r + 1) * out_rows]) for r in range(n)]


def _shards(x: np.ndarray, n: int, dtype: torch.dtype) -> list[torch.Tensor]:
    return [t.to(dtype) for t in torch.from_numpy(x).chunk(n)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 8])
def test_ring_all_gather_matches_jax(n, dtype, rng):
    jdt, tdt = DTYPES[dtype]
    x = rng.normal(size=(4 * n, 32)).astype(np.float32)
    ref = _jax_per_rank(lambda xs: jax_ring_all_gather(xs, "model"), jnp.asarray(x).astype(jdt), n,
                        P("model", None), 4 * n)
    before = ring_all_gather_launcher.launches
    ports = ring_all_gather(_shards(x, n, tdt))
    plains = ring_all_gather_plain(_shards(x, n, tdt))
    assert ring_all_gather_launcher.launches == before  # CPU tensors: the plain version, no launch
    assert len(ports) == len(plains) == n
    for r in range(n):
        assert ports[r].shape == (4 * n, 32) and ports[r].dtype == tdt
        np.testing.assert_array_equal(_bits(ports[r]), ref[r])
        np.testing.assert_array_equal(_bits(plains[r]), ref[r])


def test_ring_all_gather_plain_matches_pallas_interpret(rng):
    """K14's plain path against the TPU kernel itself, every rank's result."""
    from jax.experimental.pallas import tpu as pltpu

    from conch_tpu.kernels.collectives.ring_all_gather import ring_all_gather_pallas

    n = 8
    x = rng.normal(size=(32, 128)).astype(np.float32)
    ref = _jax_per_rank(
        lambda xs: ring_all_gather_pallas(xs, "model", n, interpret=pltpu.InterpretParams()),
        jnp.asarray(x), n, P("model", None), 32,
    )
    out = ring_all_gather_launcher(_shards(x, n, torch.float32))
    for r in range(n):
        np.testing.assert_array_equal(_bits(out[r]), ref[r])


def _matmul_tolerance(dtype: str) -> float:
    return 1e-4 if dtype == "float32" else 1e-2


@pytest.mark.parametrize("dtype", DTYPES)
def test_overlapped_allgather_matmul_matches_jax(dtype, rng):
    jdt, tdt = DTYPES[dtype]
    n, m, k, nn = 8, 8, 64, 128
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, nn)).astype(np.float32)
    ref = jax.jit(jax.shard_map(
        lambda xs, ws: jax_allgather_matmul(xs, ws, "model"), mesh=jax_create_mesh(data=1, model=n),
        in_specs=(P(None, "model"), P(None, "model")), out_specs=P(None, "model"), check_vma=False,
    ))(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    out = overlapped_allgather_matmul(list(xt.chunk(n, dim=1)), list(wt.chunk(n, dim=1)))
    assert [tuple(o.shape) for o in out] == [(m, nn // n)] * n and out[0].dtype == tdt
    got = torch.cat(out, dim=1).float().numpy()
    tol = _matmul_tolerance(dtype)
    np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)), rtol=tol, atol=tol)
    np.testing.assert_allclose(got, x @ w, rtol=tol if dtype == "float32" else 5e-2, atol=tol if dtype == "float32" else 2e-1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_overlapped_matmul_reduce_scatter_matches_jax(dtype, rng):
    jdt, tdt = DTYPES[dtype]
    n, m, k, nn = 8, 8, 64, 128
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, nn)).astype(np.float32)
    ref = jax.jit(jax.shard_map(
        lambda xs, ws: jax_matmul_reduce_scatter(xs, ws, "model"), mesh=jax_create_mesh(data=1, model=n),
        in_specs=(P(None, "model"), P("model", None)), out_specs=P(None, "model"), check_vma=False,
    ))(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    out = overlapped_matmul_reduce_scatter(list(xt.chunk(n, dim=1)), list(wt.chunk(n, dim=0)))
    assert [tuple(o.shape) for o in out] == [(m, nn // n)] * n and out[0].dtype == tdt
    got = torch.cat(out, dim=1).float().numpy()
    tol = _matmul_tolerance(dtype)
    np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)), rtol=tol, atol=tol)


def test_ppermute_rotates_by_copy():
    xs = [torch.full((2, 3), float(r)) for r in range(4)]
    out = ppermute(xs)
    assert [o[0, 0].item() for o in out] == [3.0, 0.0, 1.0, 2.0]
    assert all(o.data_ptr() != x.data_ptr() for o in out for x in xs)


def test_mesh_shape_and_virtual_ranks():
    cpu = torch.device("cpu")
    mesh = create_mesh(data=2, model=4, devices=[cpu] * 8)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_devices("model") == [cpu] * 4 and mesh.axis_devices("data", 3) == [cpu] * 2
    assert create_mesh(model=2, devices=["cpu", "cpu", "cpu"]).shape == {"data": 1, "model": 2}


@pytest.mark.parametrize(("data", "model", "count", "match"), [
    (2, 4, 7, "needs 8 devices, have 7"),
    (1, 0, 8, "at least one device"),
    (0, 2, 8, "at least one device"),
])
def test_mesh_errors(data, model, count, match):
    with pytest.raises(ValueError, match=match):
        create_mesh(data=data, model=model, devices=[torch.device("cpu")] * count)


def test_mesh_unknown_axis():
    with pytest.raises(ValueError, match="unknown mesh axis"):
        create_mesh(devices=["cpu"]).axis_devices("tensor")


def test_mesh_default_devices_need_cuda():
    """The default devices are the CUDA devices; the CPU has none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        create_mesh()


@pytest.mark.parametrize("shards", [
    [],
    [torch.zeros(2, 3), torch.zeros(2, 4)],
    [torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.bfloat16)],
    [torch.zeros(6)],
])
def test_ring_all_gather_rejects_bad_shards(shards):
    with pytest.raises(ValueError, match="ring all-gather"):
        ring_all_gather_launcher(shards)


def test_ring_all_gather_any_dtype_and_empty():
    """The copy is dtype-blind: int8, int32 and e4m3 shards, and zero-row ones."""
    for dtype in (torch.int8, torch.int32, torch.float8_e4m3fn):
        shards = [torch.arange(r * 12, r * 12 + 12).reshape(3, 4).to(dtype) for r in range(3)]
        out = ring_all_gather_launcher(shards)
        ref = torch.arange(36).reshape(9, 4).to(dtype)
        assert all(torch.equal(o.view(torch.uint8), ref.view(torch.uint8)) for o in out)
    empty = ring_all_gather_launcher([torch.zeros(0, 5)] * 4)
    assert [tuple(o.shape) for o in empty] == [(0, 5)] * 4


def test_decode_ring_error():
    assert decode_ring_error(0) == "no error"
    assert decode_ring_error(0x40000000 | (5 << 16) | (2 << 8) | 0) == "rank 5, block 2 timed out waiting in the entry barrier"
    assert decode_ring_error(0x40000000 | (7 << 16) | (0 << 8) | 3) == "rank 7, block 0 timed out waiting in ring step 2"


def test_check_ring_error_raises_and_clears(monkeypatch):
    """A timed-out wait's error word becomes a RuntimeError that names where
    the rank waited; the word is cleared, so the next check passes."""
    word = torch.tensor([0x40000000 | (3 << 16) | (1 << 8) | 3], dtype=torch.int32)
    monkeypatch.setitem(ring_module._ERROR_WORDS, 0, word)
    with pytest.raises(RuntimeError, match="rank 3, block 1 timed out waiting in ring step 2; its outputs are incomplete"):
        check_ring_error(0)
    assert int(word.item()) == 0
    check_ring_error(0)
