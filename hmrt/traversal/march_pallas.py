"""The max-mip march as one Pallas kernel on the Triton route.

The reference renderer marches each ray in its own CUDA thread: the thread
loops over the maximum-mipmap pyramid until its ray hits or leaves the map
(SURVEY.md section 1). This kernel is that design written in Pallas. The
grid runs over blocks of `block` rays, one ray per thread; inside the block
a `lax.while_loop` runs `traversal.march.maxmip_step` until no ray of *that
block* is alive, so a block retires when its own rays end, not when the
frame's longest grazing ray does. The state stays in registers, and the
pyramid max and the four corner heights are read by vector gathers from
device memory.

The XLA march (`traversal.march.march_maxmip`) is the reference: the
kernel takes the same arguments and returns the same `MarchResult`, and
the start state, the ray constants and the step are the same functions.
Two differences in float rounding remain on the GPU: Triton may contract
a multiply and an add into one FMA where XLA does not, and its f32
division is approximate, so the kernel passes the intersectors a
correctly rounded division (`div.rn.f32`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from hmrt.traversal.intersect import INTERSECTORS
from hmrt.traversal.march import (MarchResult, MaxmipRays, init_results,
                                  maxmip_start, maxmip_step)

#: Rays per block, one per thread.
RAY_BLOCK = 128

_RAY_FIELDS = MaxmipRays._fields
_STATE_FIELDS = ("t", "lvl", "icx", "icy", "alive")


def _div_rn(a, b):
    """IEEE round-to-nearest f32 division, as XLA's `/` computes it."""
    return plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[a, b], constraints="=r,r,r",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape,
                                                          jnp.float32)])[0]


def _take_ref(ref, idx):
    return ref[idx]


def _block_kernel(*refs, n, m, levels, max_steps, intersector, pyr_size):
    n_in = len(_RAY_FIELDS) + len(_STATE_FIELDS)
    ray_refs = refs[:len(_RAY_FIELDS)]
    state_refs = refs[len(_RAY_FIELDS):n_in]
    pyr_ref, h_ref = refs[n_in:n_in + 2]
    hit_ref, t_ref, hx_ref, hy_ref, steps_ref, work_ref = refs[n_in + 2:]

    rays = MaxmipRays(*(r[...] for r in ray_refs))
    st = {k: r[...] for k, r in zip(_STATE_FIELDS, state_refs)}
    st["alive"] = st["alive"] != 0
    st = init_results(st)
    global_max = pyr_ref[pyr_size - 1]
    count = jnp.zeros(st["t"].shape, jnp.int32)   # iterations each lane ran

    def cond(c):
        st, i, _ = c
        # jnp.any (reduce_or) has no Triton lowering
        return (i < max_steps) & (jnp.max(st["alive"].astype(jnp.int32)) > 0)

    def body(c):
        st, i, count = c
        count = count + st["alive"].astype(jnp.int32)
        st = maxmip_step(st, rays, pyr_ref, h_ref, global_max, n=n, m=m,
                         levels=levels, intersector=intersector,
                         take=_take_ref)
        return st, i + 1, count

    st, i, count = jax.lax.while_loop(cond, body, (st, jnp.int32(0), count))
    hit_ref[...] = st["hit"].astype(jnp.int32)
    t_ref[...] = st["t_hit"]
    hx_ref[...] = st["hx"]
    hy_ref[...] = st["hy"]
    steps_ref[...] = jnp.full((1,), i, jnp.int32)
    work_ref[...] = jnp.full((1,), jnp.sum(count), jnp.int32)


@partial(jax.jit, static_argnames=("n", "m", "levels", "max_steps",
                                   "cell_intersect", "start_level", "any_hit",
                                   "clip", "block", "interpret"))
def march_maxmip_pallas(ox, oy, oz, dx, dy, dz, pyr_flat, heights_flat, *,
                        n: int, m: int, levels: int, max_steps: int,
                        cell_intersect: str = "triangle",
                        start_level: int | None = None,
                        any_hit: bool = False,
                        clip: tuple | None = None,
                        block: int = RAY_BLOCK,
                        interpret: bool = False) -> MarchResult:
    """`march_maxmip`'s contract as a Pallas-Triton kernel.

    `steps` is the most iterations any block ran (the XLA march's loop
    count), `work` the lane-iterations of live rays summed over blocks.
    `interpret=True` runs the kernel in the Pallas interpreter (tests on
    the CPU); it is never chosen from the backend."""
    del any_hit  # same traversal; the caller reads only the hit mask
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    global_max = pyr_flat[-1]
    rays, state = maxmip_start(ox, oy, oz, dx, dy, dz, global_max, n=n, m=m,
                               levels=levels, start_level=start_level,
                               clip=clip)
    P = ox.shape[0]
    nb = pl.cdiv(P, block)
    pad = nb * block - P
    # padding lanes start dead, so they cost their block nothing
    state = dict(state, alive=state["alive"].astype(jnp.int32))
    ins = [jnp.pad(x, (0, pad)) for x in
           (*rays, *(state[k] for k in _STATE_FIELDS))]

    intersector = INTERSECTORS[cell_intersect]
    if not interpret:
        intersector = partial(intersector, div=_div_rn)
    kernel = partial(_block_kernel, n=n, m=m, levels=levels,
                     max_steps=max_steps, intersector=intersector,
                     pyr_size=pyr_flat.shape[0])
    lane = pl.BlockSpec((block,), lambda i: (i,))
    one = pl.BlockSpec((1,), lambda i: (i,))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    hit, t_hit, hx, hy, steps, work = pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[lane] * len(ins) + [whole, whole],
        out_specs=[lane] * 4 + [one, one],
        out_shape=[jax.ShapeDtypeStruct((nb * block,), jnp.int32),
                   jax.ShapeDtypeStruct((nb * block,), jnp.float32),
                   jax.ShapeDtypeStruct((nb * block,), jnp.int32),
                   jax.ShapeDtypeStruct((nb * block,), jnp.int32),
                   jax.ShapeDtypeStruct((nb,), jnp.int32),
                   jax.ShapeDtypeStruct((nb,), jnp.int32)],
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(block // 32, 16)), num_stages=1),
        interpret=interpret,
        name="march_maxmip",
    )(*ins, pyr_flat, heights_flat)
    return MarchResult(hit[:P] != 0, t_hit[:P], hx[:P], hy[:P],
                       jnp.max(steps), jnp.sum(work))
