"""The port's collectives (``repro_torch.distributed.collectives``) against
the reference's (``repro.distributed.collectives``).

``ring_perm`` is pure Python on both sides and is held equal directly.
The reference's exchanges run inside ``shard_map``, which in pytest's
process sees one device (conftest contract), so one subprocess runs them
on 4 forced host devices and holds the port's exchanges, on the same numpy
blocks, against them.  The rest are the port's own properties: halos
round-trip, zero open ends, periodic wrap, multi-plane halos, every halo a
new buffer, ``psum``'s fixed order, and the counter each collective feeds.
"""

import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro.distributed import collectives as jax_collectives
from repro.launch import hostsim
from repro_torch.distributed import collectives

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _subprocess_env(devices=4):
    env = dict(os.environ)
    # force EXACTLY `devices`: an inherited device-count flag must not win
    flags = [t for t in env.get("XLA_FLAGS", "").split()
             if not t.startswith(hostsim.DEVICE_COUNT_FLAG)]
    flags.append(f"{hostsim.DEVICE_COUNT_FLAG}={devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return env


def _blocks(x: np.ndarray, n: int):
    return [torch.from_numpy(b.copy()) for b in np.split(x, n)]


# ---- ring_perm: the reference's, unchanged ---------------------------------
@pytest.mark.parametrize("n", range(1, 9))
def test_ring_perm_equals_the_reference(n):
    for offset in (1, 2, 3, -1, -2, -3):
        for wrap in (False, True):
            assert collectives.ring_perm(n, offset, wrap) == \
                jax_collectives.ring_perm(n, offset, wrap), (n, offset, wrap)


def test_ring_perm_refuses_an_empty_ring():
    for ring_perm in (collectives.ring_perm, jax_collectives.ring_perm):
        with pytest.raises(ValueError, match="at least one shard"):
            ring_perm(0)


# ---- the exchanges against the reference's under shard_map ----------------
_AGAINST_SHARD_MAP = textwrap.dedent('''
    import numpy as np, jax, jax.numpy as jnp, torch
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed import collectives as jc
    from repro_torch.distributed import collectives as tc

    assert jax.device_count() == 4, jax.devices()
    checked = 0
    # 1-D ring of 4 shards of 3 planes each
    x = np.arange(12 * 3 * 2, dtype=np.float32).reshape(12, 3, 2)
    mesh = Mesh(np.array(jax.devices()), ("s",))
    for halo in (1, 2, 3):
        for wrap in (False, True):
            def local(u, halo=halo, wrap=wrap):
                lo, hi = jc.halo_exchange(u, "s", 4, axis=0, halo=halo,
                                          wrap=wrap)
                return jnp.concatenate([lo, hi], axis=0)
            ref = np.asarray(jax.jit(shard_map(
                local, mesh, in_specs=P("s"), out_specs=P("s")))(x))
            blocks = [torch.from_numpy(b.copy()) for b in np.split(x, 4)]
            lo, hi = tc.halo_exchange(blocks, axis=0, halo=halo, wrap=wrap)
            mine = np.concatenate(
                [torch.cat([l, h]).numpy() for l, h in zip(lo, hi)])
            assert np.array_equal(ref, mine), ("1-D", halo, wrap)
            checked += 1
    # the same ring along axis 1, and a periodic shift
    y = np.ascontiguousarray(np.moveaxis(x, 0, 1))
    def local(u):
        lo, hi = jc.halo_exchange(u, "s", 4, axis=1, halo=2)
        return jnp.concatenate([lo, hi], axis=1)
    ref = np.asarray(jax.jit(shard_map(local, mesh, in_specs=P(None, "s"),
                                       out_specs=P(None, "s")))(y))
    lo, hi = tc.halo_exchange(
        [torch.from_numpy(b.copy()) for b in np.split(y, 4, axis=1)],
        axis=1, halo=2)
    mine = np.concatenate([torch.cat([l, h], 1).numpy()
                           for l, h in zip(lo, hi)], axis=1)
    assert np.array_equal(ref, mine), "axis 1"
    ref = np.asarray(jax.jit(shard_map(
        lambda u: jc.shift(u, "s", 4, offset=1, wrap=True), mesh,
        in_specs=P("s"), out_specs=P("s")))(x))
    mine = np.concatenate([t.numpy() for t in tc.shift(
        [torch.from_numpy(b.copy()) for b in np.split(x, 4)], 1,
        wrap=True)])
    assert np.array_equal(ref, mine), "periodic shift"
    checked += 2
    # 2-D (2, 2) mesh: one exchange per mesh axis, on blocks of (3, 4, 5)
    x2 = np.arange(6 * 8 * 5, dtype=np.float32).reshape(6, 8, 5)
    mesh2 = Mesh(np.array(jax.devices()).reshape(2, 2), ("z", "y"))
    for halo in (1, 2):
        for wrap in (False, True):
            def local(u, halo=halo, wrap=wrap):
                (lz, hz), (ly, hy) = jc.halo_exchange_nd(
                    u, ("z", "y"), (2, 2), axes=(0, 1), halo=halo,
                    wrap=wrap)
                return lz, hz, ly, hy
            refs = [np.asarray(r) for r in jax.jit(shard_map(
                local, mesh2, in_specs=P("z", "y"),
                out_specs=(P("z", "y"),) * 4))(x2)]
            grid = [[torch.from_numpy(x2[iz * 3:(iz + 1) * 3,
                                         iy * 4:(iy + 1) * 4].copy())
                     for iy in range(2)] for iz in range(2)]
            (lz, hz), (ly, hy) = tc.halo_exchange_nd(
                grid, axes=(0, 1), halo=halo, wrap=wrap)
            for ref, mine in zip(refs, (lz, hz, ly, hy)):
                whole = np.concatenate([np.concatenate(
                    [t.numpy() for t in row], axis=1) for row in mine],
                    axis=0)
                assert np.array_equal(ref, whole), ("2-D", halo, wrap)
            checked += 1
    print(f"checked {checked} exchanges against the reference's")
''')


def test_exchanges_match_the_reference_under_shard_map():
    """``shift``, ``halo_exchange`` (axis 0 and 1, halo 1-3, open and
    periodic) and ``halo_exchange_nd`` on a (2, 2) mesh (halo 1-2, open and
    periodic): the port's halos equal the reference's, run under
    ``shard_map`` on 4 forced host devices, on the same numpy blocks."""
    out = subprocess.run([sys.executable, "-c", _AGAINST_SHARD_MAP],
                         env=_subprocess_env(4), capture_output=True,
                         text=True, timeout=240, cwd=REPO_ROOT)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n" \
                                f"{out.stderr}"
    assert "checked 12 exchanges against the reference's" in out.stdout


# ---- the port's own properties --------------------------------------------
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_halo_exchange_round_trips_with_zero_open_ends(n):
    x = np.arange(2 * n * 3, dtype=np.float32).reshape(2 * n, 3)
    lo, hi = collectives.halo_exchange(_blocks(x, n), axis=0)
    xs = x.reshape(n, 2, 3)
    for i in range(n):
        want_lo = xs[i - 1][-1:] if i > 0 else np.zeros((1, 3), np.float32)
        want_hi = xs[i + 1][:1] if i < n - 1 else np.zeros((1, 3),
                                                           np.float32)
        np.testing.assert_array_equal(lo[i].numpy(), want_lo)
        np.testing.assert_array_equal(hi[i].numpy(), want_hi)


@pytest.mark.parametrize("halo", [1, 2, 3])
def test_periodic_and_multi_plane_halos(halo):
    n, planes = 4, 3
    x = np.arange(n * planes * 2, dtype=np.float32).reshape(n * planes, 2)
    xs = x.reshape(n, planes, 2)
    lo, hi = collectives.halo_exchange(_blocks(x, n), axis=0, halo=halo,
                                       wrap=True)
    for i in range(n):
        np.testing.assert_array_equal(lo[i].numpy(),
                                      xs[(i - 1) % n][-halo:])
        np.testing.assert_array_equal(hi[i].numpy(), xs[(i + 1) % n][:halo])
    shifted = collectives.shift(_blocks(x, n), -1, wrap=True)
    for i in range(n):
        np.testing.assert_array_equal(shifted[i].numpy(), xs[(i + 1) % n])


def test_halo_wider_than_the_block_raises():
    with pytest.raises(ValueError, match="exceeds local extent"):
        collectives.halo_exchange(_blocks(np.zeros((4, 2), np.float32), 2),
                                  axis=0, halo=3)


def test_halo_exchange_nd_validates_alignment():
    grid = [[torch.zeros(2, 2)] * 2] * 2
    with pytest.raises(ValueError, match="must align"):
        collectives.halo_exchange_nd(grid, axes=(0,))
    with pytest.raises(ValueError, match="must align"):
        jax_collectives.halo_exchange_nd(np.ones((4, 4)), ("a", "b"), (2,))


def test_every_halo_is_a_new_buffer():
    """Shards that share a device still copy: no halo aliases its source
    block, so an exchange on one card moves the bytes it would move
    between cards."""
    blocks = _blocks(np.arange(16, dtype=np.float32).reshape(8, 2), 4)
    lo, hi = collectives.halo_exchange(blocks, axis=0, wrap=True)
    sources = {b.untyped_storage().data_ptr() for b in blocks}
    for h in lo + hi:
        assert h.untyped_storage().data_ptr() not in sources
        assert h.is_contiguous()


def test_psum_adds_in_shard_order_and_copies_to_every_shard():
    parts = [torch.tensor(v, dtype=torch.float32)
             for v in (1e8, 1.0, -1e8, 1.0)]
    with collectives.counting() as counts:
        sums = collectives.psum(parts)
    # shard order: ((1e8 + 1) - 1e8) + 1 in float32 is 1, not 2
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    assert float(want) == 1.0
    assert all(torch.equal(s, want) for s in sums)
    ptrs = {s.untyped_storage().data_ptr() for s in sums}
    assert len(ptrs) == len(sums)
    assert counts == {"ppermute": 0, "psum": 1, "all_gather": 0}


def test_each_collective_counts_itself():
    blocks = _blocks(np.zeros((8, 4, 3), np.float32), 4)
    grid = [[torch.zeros(2, 3, 3)] * 2 for _ in range(2)]
    with collectives.counting() as outer:
        collectives.shift(blocks)
        with collectives.counting() as inner:
            collectives.halo_exchange(blocks, axis=0)
            collectives.halo_exchange_nd(grid, axes=(0, 1))
            collectives.psum(blocks)
    assert inner == {"ppermute": 6, "psum": 1, "all_gather": 0}
    assert outer == {"ppermute": 7, "psum": 1, "all_gather": 0}
    collectives.shift(blocks)       # outside any counter: counted nowhere
    assert outer["ppermute"] == 7


def test_counters_are_per_thread():
    blocks = _blocks(np.zeros((4, 2), np.float32), 2)
    seen = {}

    def other():
        with collectives.counting() as c:
            collectives.psum(blocks)
        seen["other"] = dict(c)

    with collectives.counting() as mine:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert mine == {"ppermute": 0, "psum": 0, "all_gather": 0}
    assert seen["other"]["psum"] == 1
