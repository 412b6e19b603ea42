"""PyTorch port of ``radar_tpu/parallel/pallas_ring.py`` and the
range-sharded pulse compression: K6's plain version (the
``batch_isend_irecv`` ring) as gloo ranks on the CPU against JAX's
``halo_right_permute`` in TPU-interpret mode on the suite's virtual CPU
devices (the ``tests/test_pallas_ring.py`` cases), and
``pulse_compress_range_sharded`` against JAX's and ``np.convolve``. K6
itself runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from radar_tpu.parallel.collectives import \
    pulse_compress_range_sharded as j_pc_range
from radar_tpu.parallel.mesh import make_mesh as j_make_mesh
from radar_tpu.parallel.pallas_ring import \
    halo_right_permute as j_halo_right_permute
from radar_tpu_torch.parallel import dryrun
from radar_tpu_torch.parallel.mesh import make_mesh
from radar_tpu_torch.parallel.multihost import run_ranks
from radar_tpu_torch.parallel.pallas_ring import (flag_scopes,
                                                  halo_right_permute,
                                                  overlap_save_input_plain)

ROWS, HALO = 8, 5
SIZES = (2, 4, 8)
# (shards, filter length): tests/test_pallas_ring.py:48
PC_CASES = ((4, 33), (8, 17))


def _halo_input(n):
    return np.arange(ROWS * 64 * n, dtype=np.float32).reshape(ROWS, 64 * n)


def _pc_input(n, lh):
    rng = np.random.default_rng(0)
    rows, s = 16, 128 * n
    x = (rng.standard_normal((rows, s))
         + 1j * rng.standard_normal((rows, s))).astype(np.complex64)
    return x, rng.standard_normal(lh).astype(np.float32)


def _convolve_input():
    """tests/test_parallel.py:38-49: complex128, 4 shards, 33 taps."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 256)) + 1j * rng.normal(size=(5, 256))
    return x, rng.normal(size=33)


@pytest.fixture(scope="module")
def ranks():
    """One launch per ring size: the halo ring; at 4 ranks also the
    (4, 33) PC case and the complex128 case, at 8 ranks the (8, 17) case
    and (4, 33) again on a (dp=2, cpi=4) mesh (an inert extra axis)."""
    out = {}
    for n in SIZES:
        cases = {}
        for shards, lh in PC_CASES:
            x, h = _pc_input(shards, lh)
            if shards == n:
                cases[(shards, lh)] = ((1, 1, shards), x, h, 256)
            elif n == 8:
                cases[("dp2", shards, lh)] = ((8 // shards, 1, shards), x,
                                              h, 256)
        if n == 4:
            cases["c128"] = ((1, 1, 4),) + _convolve_input() + (128,)
        out[n] = run_ranks(dryrun.ring, n, _halo_input(n), HALO, cases,
                           "cpu", device="cpu", timeout=180)[0]
    return out


def _jax_halo(n):
    """JAX's interpret-mode ring on make_mesh(cpi=n): [rows, halo * n]."""
    mesh = j_make_mesh(cpi=n)
    s_local = 64

    def local(xl):
        return j_halo_right_permute(mesh, ROWS, s_local, HALO, axis="cpi",
                                    interpret=True)(xl)

    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(None, "cpi"),),
                          out_specs=P(None, "cpi"), check_vma=False))
    with mesh:
        return np.asarray(f(jnp.asarray(_halo_input(n))))


@pytest.mark.parametrize("n", SIZES)
def test_plain_halo_ring_matches_jax_interpret(ranks, n):
    """Each rank's received halo is bit-identical to JAX's remote-DMA ring:
    rank i gets rank i-1's trailing columns, rank 0 zeros."""
    got = ranks[n]["halo"]
    np.testing.assert_array_equal(got, _jax_halo(n))
    np.testing.assert_array_equal(got[:, :HALO], 0.0)


@pytest.mark.parametrize("n", SIZES)
def test_overlap_save_input_plain_is_halo_shard_zeros(ranks, n):
    """The overlap-save route's plain version (the image of the receiver's
    [rows, nfft] slot) is JAX's remote-DMA halo, then the rank's own shard,
    then zeros: the ring's halo concatenated and zero-padded."""
    got = ranks[n]["os_input"]
    s_local, nfft = 64, 64 + HALO + 3
    halo = _jax_halo(n)
    x = _halo_input(n)
    for i in range(n):
        block = got[:, i * nfft:(i + 1) * nfft]
        np.testing.assert_array_equal(block[:, :HALO],
                                      halo[:, i * HALO:(i + 1) * HALO])
        np.testing.assert_array_equal(block[:, HALO:HALO + s_local],
                                      x[:, i * s_local:(i + 1) * s_local])
        np.testing.assert_array_equal(block[:, HALO + s_local:], 0.0)


@pytest.mark.parametrize("shards,lh", PC_CASES)
def test_rdma_equals_ppermute(ranks, shards, lh):
    """halo_impl="rdma" (K6's plain version on CPU tensors) and
    "ppermute" give bit-identical output, on a mesh of the ring alone and
    on one with an extra dp axis."""
    outs = [ranks[shards][(shards, lh)]]
    if shards < 8:
        outs.append(ranks[8][("dp2", shards, lh)])
    for out in outs:
        assert np.max(np.abs(out["ppermute"])) > 0
        np.testing.assert_array_equal(out["rdma"], out["ppermute"])


@pytest.mark.parametrize("shards,lh", PC_CASES)
def test_range_sharded_pc_matches_jax(ranks, shards, lh):
    """Both transports within rtol 1e-5 of the max of JAX's rdma and
    ppermute outputs at complex64 (torch.fft and XLA's FFT sum in other
    orders)."""
    x, h = _pc_input(shards, lh)
    mesh = j_make_mesh(dp=8 // shards, cpi=shards)
    with mesh:
        want = [np.asarray(j_pc_range(mesh, h, nfft=256, axis="cpi",
                                      halo_impl=impl, interpret=True)(
                                          jnp.asarray(x)))
                for impl in ("ppermute", "rdma")]
    np.testing.assert_array_equal(want[0], want[1])
    scale = np.max(np.abs(want[0]))
    out = ranks[shards][(shards, lh)]
    for impl in ("ppermute", "rdma"):
        np.testing.assert_allclose(out[impl], want[0], rtol=0,
                                   atol=1e-5 * scale)


def test_range_sharded_pc_complex128_matches_convolve(ranks):
    """The causal convolution truncated to len(x), within 1e-9."""
    x, h = _convolve_input()
    want = np.stack([np.convolve(x[i], h)[:256] for i in range(5)])
    for impl in ("ppermute", "rdma"):
        np.testing.assert_allclose(ranks[4]["c128"][impl], want, rtol=1e-9,
                                   atol=1e-9)


def test_halo_exchange_on_one_rank():
    """Without a process group the mesh is one rank: the exchange returns
    the causal edge's zeros, checks its input's shape and dtype, and
    refuses a dtype that is not a whole number of 4-byte words."""
    mesh = make_mesh(device="cpu")
    ex = halo_right_permute(mesh, 3, 10, 4, dtype=torch.complex64)
    x = torch.ones((3, 10), dtype=torch.complex64)
    assert torch.equal(ex(x), torch.zeros((3, 4), dtype=torch.complex64))
    for bad in (torch.ones((3, 9), dtype=torch.complex64),
                torch.ones((3, 10), dtype=torch.float32)):
        with pytest.raises(ValueError, match="the exchange takes"):
            ex(bad)
    with pytest.raises(ValueError, match="halo"):
        halo_right_permute(mesh, 3, 10, 11)
    for dtype in (torch.bfloat16, torch.float16, torch.uint8):
        with pytest.raises(ValueError, match="4, 8 or 16 bytes"):
            halo_right_permute(mesh, 3, 10, 3, dtype=dtype)


def test_overlap_save_input_on_one_rank():
    """On one rank the overlap-save input is [zeros | x | zeros] (the causal
    edge), equal to the plain helper's ``cat`` + pad and to a pad of
    ``x``; ``nfft`` must cover halo + s_local, which it is by default."""
    mesh = make_mesh(device="cpu")
    x = torch.arange(30, dtype=torch.float32).reshape(3, 10) + 1j
    ex = halo_right_permute(mesh, 3, 10, 4, dtype=torch.complex64, nfft=16)
    got = ex.overlap_save_input(x.to(torch.complex64))
    want = torch.nn.functional.pad(x.to(torch.complex64), (4, 2))
    assert got.shape == (3, 16) and torch.equal(got, want)
    assert torch.equal(got, overlap_save_input_plain(
        x.to(torch.complex64), mesh, 4, 16))
    with pytest.raises(ValueError, match="nfft"):
        halo_right_permute(mesh, 3, 10, 4, nfft=13)
    got = halo_right_permute(mesh, 3, 10, 4).overlap_save_input(
        torch.ones(3, 10))
    assert torch.equal(got, torch.nn.functional.pad(torch.ones(3, 10),
                                                    (4, 0)))


@pytest.mark.parametrize("cards", [[0, 0, 0, 0], [0, 1, 2, 3], [0, 1, 0],
                                   [0, 0, 1, 1]])
def test_flag_scopes_pair_across_each_link(cards):
    """Each rank's flags with a neighbour take the system's scope exactly
    where that neighbour sits on another card, and the two ends of every
    link agree: rank i's push (right scope) and rank i + 1's fill (left
    scope) pair on the same flag, also where ranks are dealt to cards
    unevenly (three ranks on two cards: 0, 1, 0)."""
    n = len(cards)
    scopes = [flag_scopes(cards, i) for i in range(n)]
    for i, (left, right) in enumerate(scopes):
        assert right == int(cards[(i + 1) % n] != cards[i])
        assert left == int(cards[(i - 1) % n] != cards[i])
        assert right == scopes[(i + 1) % n][0]
