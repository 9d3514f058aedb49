"""Fixtures and tables shared by the port's tests (tests/test_torch_*.py)."""

import os
import shutil

import numpy as np
import pytest
import torch


def share_native_builder():
    """Make the reference's native SAH builder load the port's copy of its
    library. Call it at import of every port test module that reaches the
    reference's build_world_bvh, build_scene_flat or native.

    The reference (vk_gltf_renderer_tpu/native) returns its cached .so as
    soon as the path exists, while g++ still writes it in place; on a cold
    cache a second test worker then loads a half-written file ("file too
    short"). The port's copy builds to a temporary name and renames it
    (vk_gltf_renderer_tpu_torch/native), and both libraries are named by
    the sha256 of the same bvh_builder.cpp text (held equal by
    tests/test_torch_host.py). So this builds the port's library and points
    the reference's cache directory at the port's build directory, where
    the reference finds a complete file and never starts g++. It also
    seeds the reference's own cache file by copy and rename, which narrows
    the window in which the reference's own tests race each other there.

    Not called when this module is imported: tests/test_torch_cuda.py
    imports it on the card's machine, which has no JAX, and the reference
    package imports jax whenever JAX_PLATFORMS is set."""
    from vk_gltf_renderer_tpu import native as jnative
    from vk_gltf_renderer_tpu_torch import native as tnative

    if tnative.get_lib() is None:
        return
    own = jnative._CACHE
    jnative._CACHE = tnative._CACHE
    path = jnative._build_lib()  # the port's file: found, not built
    seed = own / path.name
    if path != seed and not seed.exists():
        own.mkdir(parents=True, exist_ok=True)
        tmp = seed.with_suffix(f".{os.getpid()}.tmp")
        shutil.copyfile(path, tmp)
        os.replace(tmp, seed)


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


def deep_chain_bvh4(levels=24, stubs=False):
    """A degenerate BVH4 that no stack of 64 entries can walk: `levels`
    rows whose 4 child boxes are all [-1, 1]^3, child slot 0 the next row
    and slots 1-3 an empty leaf (code -1: tris128 row 0, no triangle),
    every split axis x. A ray from inside the box with dx >= 0 enters all
    four children of every row, pushes them far first and pops slot 0, so
    its stack grows by 3 a row: past 21 rows the pushes of row 21's slots
    2, 1 and 0 are dropped (3 a ray) and the walk ends in empty leaves.
    Returns (nodes4_fi [L,32] f32, nodes4_sc [L,8] i32, tris128 [1,128]
    f32) as numpy arrays, the root code being 0.

    stubs: slots 1-3 of every chain row are instead one more row (row L)
    whose four children are empty leaves. The v5 walk pops a chain row and
    three stubs a step and pushes 16 children, so its stack grows by 12 a
    row and overflows a 128-entry stack (the single-pop walks grow by 3 a
    row as before)."""
    fi = np.zeros((levels + stubs, 32), np.float32)
    fi[:, 0:24] = np.tile(np.float32([-1, -1, -1, 1, 1, 1]), 4)
    fi[:levels, 24] = np.append(np.arange(1, levels), -1)
    fi[:levels, 25:28] = levels if stubs else -1
    fi[levels:, 24:28] = -1
    sc = np.zeros((levels + stubs, 8), np.int32)
    sc[:, 0:4] = fi[:, 24:28]
    return fi, sc, np.zeros((1, 128), np.float32)


def deep_chain(levels, arity):
    """deep_chain_bvh4's chain for the BVH2 (arity 2, nodes_fi) and BVH16
    (arity 16, nodes16_fi) walks: `levels` rows whose child boxes are all
    [-1, 1]^3, child slot 0 the next row (an empty leaf in the last) and
    the other slots empty leaves (code -1), every split axis x. A ray from
    inside the box with dx >= 0 enters every child, so visit position p is
    slot p: it pushes the arity - 1 leaves and then the next row, pops that
    row (the BVH2 walk descends into it instead), and its stack grows by
    arity - 1 a row. Returns (nodes [L,8A] f32, tris128 [1,128] f32) as
    numpy arrays, the root code being 0.

    BVH2 (128 entries): rows 0-127 fit, and every row from row 128 on
    drops its far leaf, 1 push a live ray. BVH16 (256 entries): rows 0-16
    fit, and a chain of 18 rows or more drops 15 (row 17's children but
    the one that fills the stack)."""
    a = arity
    nodes = np.zeros((levels, 8 * a), np.float32)
    nodes[:, 0 : 6 * a] = np.tile(np.float32([-1, -1, -1, 1, 1, 1]), a)
    nodes[:, 6 * a : 7 * a] = -1
    nodes[:, 6 * a] = np.append(np.arange(1, levels), -1)
    return nodes, np.zeros((1, 128), np.float32)


def deep_chain_split(levels):
    """deep_chain's BVH2 chain as the v1 walk's split tables: internal nodes
    0 .. levels-1, both child boxes [-1, 1]^3, the left child the next node
    (the leaf for the last one), the right child the one leaf node
    `levels`, which holds tris row 0: a degenerate triangle (all zeros) that
    nothing hits; every split axis x. A ray from inside the box with dx >= 0
    enters both children of every node, the left one nearer: the v1 walk
    pushes the leaf and descends into the next node, so its stack grows by
    1 a node, and from node 128 on every live ray drops one push a node
    (the walk before, which pushed both children, lost the chain at node
    127 instead). Returns (nodes_f [L+1,16] f32, nodes_i [L+1,8] i32, tris
    [9,16] f32) as numpy arrays."""
    nodes_f = np.zeros((levels + 1, 16), np.float32)
    nodes_f[:levels, 0:12] = np.tile(np.float32([-1, -1, -1, 1, 1, 1]), 2)
    nodes_i = np.zeros((levels + 1, 8), np.int32)
    nodes_i[:levels, 0] = np.arange(1, levels + 1)
    nodes_i[:levels, 1] = levels
    nodes_i[levels, 3] = 1  # first 0, count 1
    nodes_i[:, 4] = np.append(-1, np.arange(levels))  # parents
    return nodes_f, nodes_i, np.zeros((9, 16), np.float32)


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
