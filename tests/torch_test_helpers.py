"""Fixtures and tables shared by the port's tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """One intra-op thread while the test runs. The wavefront walk issues
    ~80 tiny torch ops per step; with several test workers each running a
    full thread pool on the same cores, those ops spend far longer
    synchronising threads than computing (a 6-worker run took ~50x the
    single-process time). The walk is elementwise, so its results do not
    depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deep_chain_bvh4(levels=24):
    """A degenerate BVH4 that no stack of 64 entries can walk: `levels`
    rows whose 4 child boxes are all [-1, 1]^3, child slot 0 the next row
    and slots 1-3 an empty leaf (code -1: tris128 row 0, no triangle),
    every split axis x. A ray from inside the box with dx >= 0 enters all
    four children of every row, pushes them far first and pops slot 0, so
    its stack grows by 3 a row: past 21 rows the pushes of row 21's slots
    2, 1 and 0 are dropped (3 a ray) and the walk ends in empty leaves.
    Returns (nodes4_fi [L,32] f32, nodes4_sc [L,8] i32, tris128 [1,128]
    f32) as numpy arrays, the root code being 0."""
    fi = np.zeros((levels, 32), np.float32)
    fi[:, 0:24] = np.tile(np.float32([-1, -1, -1, 1, 1, 1]), 4)
    fi[:, 24] = np.append(np.arange(1, levels), -1)
    fi[:, 25:28] = -1
    sc = np.zeros((levels, 8), np.int32)
    sc[:, 0:4] = fi[:, 24:28]
    return fi, sc, np.zeros((1, 128), np.float32)


def deep_chain_rays(n, seed):
    """n rays from inside deep_chain_bvh4's box with dx >= 0, as the 8 [N]
    f32 numpy components (tmin 0, tmax 1e32)."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 0] = np.abs(rd[:, 0])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return [*(np.ascontiguousarray(a) for a in (*ro.T, *rd.T)), np.zeros(n, np.float32),
            np.full(n, 1e32, np.float32)]
