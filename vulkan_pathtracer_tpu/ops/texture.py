"""Bilinear texture sampling over a flat texel pool.

Parity target: the reference's single sampler — linear min/mag filter,
repeat addressing on u/v, no mips (max_lod = 0), unnormalized = false
(RayTracingPipeline.zig:54-70) — over ``r8g8b8a8_unorm`` images
(RaytracingPass.zig:505), i.e. **no sRGB decode**: texels are read
linearly as byte/255.

Design: all textures live in one (P, 4) uint8 texel pool with
per-texture offset/width/height tables; a sample is 4 pool gathers +
lerp math, fully batched over rays.  Texture index 0 is a 1x1
white dummy so "no texture" lanes run the same code path and multiply
by exactly 1.0 (matching the factor-only branch of
material.glsl:36-53).
"""

from __future__ import annotations

import jax.numpy as jnp


def sample_bilinear(tex_texels, tex_offset, tex_width, tex_height,
                    tex_index, uv):
    """Sample textures[tex_index] at uv with repeat wrap + bilinear.

    tex_texels: (P, 4) uint8; tex_offset/width/height: (NT,) int32;
    tex_index: (N,) int32; uv: (N, 2) f32.  Returns (N, 4) f32 in [0,1].
    """
    off = jnp.take(tex_offset, tex_index)
    w = jnp.take(tex_width, tex_index)
    h = jnp.take(tex_height, tex_index)
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)

    # GLSL repeat wrap: work in unwrapped texel space, wrap the integer
    # texel coordinates (texel centers at i + 0.5).
    x = uv[:, 0] * wf - 0.5
    y = uv[:, 1] * hf - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0

    def wrap(i, extent):
        return jnp.mod(i.astype(jnp.int32), extent)

    x0i = wrap(x0, w)
    x1i = wrap(x0 + 1.0, w)
    y0i = wrap(y0, h)
    y1i = wrap(y0 + 1.0, h)

    def fetch(xi, yi):
        addr = off + yi * w + xi
        texel = jnp.take(tex_texels, addr, axis=0)
        return texel.astype(jnp.float32) * jnp.float32(1.0 / 255.0)

    c00 = fetch(x0i, y0i)
    c10 = fetch(x1i, y0i)
    c01 = fetch(x0i, y1i)
    c11 = fetch(x1i, y1i)

    fx = fx[:, None]
    fy = fy[:, None]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy
