"""Mixture BRDF: Disney-style diffuse + GGX-VNDF specular.

Vectorized JAX re-implementation of the reference's
``src/shaders/brdf.glsl`` with identical numeric semantics, operating
on batched arrays with a trailing xyz axis.  Every formula keeps the
reference's exact form — including its idiosyncrasies (e.g. the GGX
distribution denominator uses ``half_dot_normal`` un-squared,
brdf.glsl:39) — because image parity is the contract.

All functions are pure and shape-polymorphic: inputs are (..., 3) or
(...,) f32 arrays; there is no data-dependent control flow, so they
fuse into the surrounding XLA program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from vulkan_pathtracer_tpu.ops.vecmath import dot, mix, normalize, luminance

M_PI = 3.141592653589793238462643


class ShadingInfo(NamedTuple):
    """Mirror of brdf.glsl:6-13 (SoA over rays)."""

    normal: jnp.ndarray          # (..., 3)
    out_dir: jnp.ndarray         # (..., 3) — towards the viewer
    lambert_out: jnp.ndarray     # (...,)   — dot(normal, out_dir)
    diffuse_albedo: jnp.ndarray  # (..., 3)
    fresnel_0: jnp.ndarray       # (..., 3)
    roughness: jnp.ndarray       # (...,)


def fresnel_schlick(f0, f90, cosine_theta):
    """brdf.glsl:15-20. f0/f90 may be (...,3) or (...,)."""
    factor = 1.0 - cosine_theta
    factor_sq = factor * factor
    factor_fifth = factor_sq * factor_sq * factor
    if f0.ndim == factor_fifth.ndim + 1:
        factor_fifth = factor_fifth[..., None]
    return mix(f0, f90, factor_fifth)


def brdf(shading: ShadingInfo, light_dir):
    """Full BRDF evaluation — brdf.glsl:22-50. Returns (..., 3)."""
    n_dot_light = dot(shading.normal, light_dir)
    n_dot_view = shading.lambert_out

    half_vector = normalize(light_dir + shading.out_dir)
    half_dot_view = dot(half_vector, shading.out_dir)

    # Diffuse: double-Schlick retro term with f90 from half_dot_view.
    f90 = (half_dot_view * half_dot_view) * (2.0 * shading.roughness) + 0.5
    one = jnp.ones_like(f90)
    diffuse_fresnel = fresnel_schlick(one, f90, n_dot_view) * fresnel_schlick(
        one, f90, n_dot_light
    )
    result = diffuse_fresnel[..., None] * shading.diffuse_albedo

    # GGX specular. NOTE: denominator uses half_dot_normal (NOT squared),
    # exactly as the reference wrote it (brdf.glsl:38-40).
    half_dot_normal = dot(half_vector, shading.normal)
    roughness_sq = shading.roughness * shading.roughness
    denominator = half_dot_normal * (roughness_sq - 1.0) + 1.0
    distribution = roughness_sq / (denominator * denominator)

    # Height-correlated Smith G, brdf.glsl:42-44.
    masking = n_dot_light * jnp.sqrt(
        (n_dot_view - roughness_sq * n_dot_view) * n_dot_view + roughness_sq
    )
    shadowing = n_dot_view * jnp.sqrt(
        (n_dot_light - roughness_sq * n_dot_light) * n_dot_light + roughness_sq
    )
    geometry = 0.5 / (masking + shadowing)

    specular_fresnel = fresnel_schlick(
        shading.fresnel_0, jnp.ones_like(shading.fresnel_0),
        jnp.maximum(0.0, half_dot_view),
    )
    result = result + (distribution * geometry)[..., None] * specular_fresnel
    result = result / M_PI

    # brdf.glsl:27: if (min(n_dot_light, n_dot_view) < 0.0) return 0.
    below = jnp.minimum(n_dot_light, n_dot_view) < 0.0
    return jnp.where(below[..., None], 0.0, result)


def sample_ggx_vndf(view_dir, roughness, rx, ry):
    """GGX visible-normal sampling — brdf.glsl:52-66.

    view_dir: (..., 3) in tangent space; roughness: (...,) (isotropic,
    applied to xy as in the vec2(roughness) call site); rx, ry: (...,)
    uniforms. Returns the sampled half vector (..., 3), tangent space.
    """
    r = roughness[..., None]
    transformed_view = normalize(
        jnp.concatenate(
            [view_dir[..., :2] * r, view_dir[..., 2:3]], axis=-1
        )
    )
    phi = (2.0 * M_PI) * rx
    z = 1.0 - ry * (1.0 + transformed_view[..., 2])
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    hemisphere = jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), z], axis=-1
    )
    summed = hemisphere + transformed_view
    half_vector = normalize(
        jnp.concatenate([summed[..., :2] * r, summed[..., 2:3]], axis=-1)
    )
    return half_vector


def get_ggx_vndf_density(n_dot_view, half_dot_normal, half_dot_view, roughness):
    """brdf.glsl:68-79 (returns 0 where half_dot_normal < 0)."""
    roughness_sq = roughness * roughness
    inv_roughness_sq = 1.0 - roughness_sq
    denominator = n_dot_view + jnp.sqrt(
        roughness_sq + inv_roughness_sq * n_dot_view * n_dot_view
    )
    d_vis = jnp.maximum(0.0, half_dot_view) * (2.0 / M_PI) / denominator
    m_sq_term = 1.0 - inv_roughness_sq * half_dot_normal * half_dot_normal
    density = d_vis * roughness_sq / (m_sq_term * m_sq_term)
    return jnp.where(half_dot_normal < 0.0, 0.0, density)


def sample_ggx_in_dir(view_dir, roughness, rx, ry):
    """brdf.glsl:81-84: -reflect(view, half) = 2*dot(v,h)*h - v."""
    half_vector = sample_ggx_vndf(view_dir, roughness, rx, ry)
    return 2.0 * dot(view_dir, half_vector)[..., None] * half_vector - view_dir


def get_ggx_in_dir_density(n_dot_view, view_dir, light_dir, normal, roughness):
    """brdf.glsl:86-93."""
    half_vector = normalize(light_dir + view_dir)
    half_dot_view = dot(half_vector, view_dir)
    half_dot_normal = dot(half_vector, normal)
    density = get_ggx_vndf_density(
        n_dot_view, half_dot_normal, half_dot_view, roughness
    )
    return density / (4.0 * half_dot_view)


def get_shading_space(normal):
    """Branchless tangent frame — brdf.glsl:95-105.

    Returns the three columns (tangent, bitangent, normal) of the
    tangent-to-world matrix as (..., 3) arrays.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    sign = jnp.where(nz > 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    col0 = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    col1 = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return col0, col1, normal


def _to_world(col0, col1, col2, v):
    """tangent_to_world * v for column triples."""
    return (
        col0 * v[..., 0:1] + col1 * v[..., 1:2] + col2 * v[..., 2:3]
    )


def _to_local(col0, col1, col2, v):
    """transpose(tangent_to_world) * v."""
    return jnp.stack([dot(col0, v), dot(col1, v), dot(col2, v)], axis=-1)


def sample_hemisphere_psa(rx, ry):
    """Cosine (projected-solid-angle) hemisphere sample — brdf.glsl:107-113."""
    phi = (2.0 * M_PI) * rx
    radius = jnp.sqrt(ry)
    z = jnp.sqrt(1.0 - radius * radius)
    return jnp.stack(
        [radius * jnp.cos(phi), radius * jnp.sin(phi), z], axis=-1
    )


def get_hemisphere_psa_density(sampled_z):
    """brdf.glsl:115-117."""
    return jnp.maximum(0.0, sampled_z) / M_PI


def get_diffuse_sampling_probability(shading: ShadingInfo):
    """brdf.glsl:119-122: min(0.5, luminance(diffuse_albedo))."""
    return jnp.minimum(0.5, luminance(shading.diffuse_albedo))


def sample_brdf(shading: ShadingInfo, rx, ry):
    """Mixture sampling — brdf.glsl:124-139.

    Both branches are evaluated and selected with where() (no lane
    divergence); the random-number remapping per branch matches
    the GLSL exactly.
    """
    col0, col1, col2 = get_shading_space(shading.normal)
    diffuse_prob = get_diffuse_sampling_probability(shading)

    take_diffuse = rx < diffuse_prob

    # Diffuse branch: rx / p. (p can be 0 when the diffuse branch is
    # never taken; guard the unselected lane against inf/nan.)
    rx_d = rx / jnp.maximum(diffuse_prob, jnp.float32(1e-30))
    diffuse_dir = _to_world(col0, col1, col2, sample_hemisphere_psa(rx_d, ry))

    # Specular branch: (rx - p) / (1 - p)
    rx_s = (rx - diffuse_prob) / (1.0 - diffuse_prob)
    local_view = _to_local(col0, col1, col2, shading.out_dir)
    local_light = sample_ggx_in_dir(local_view, shading.roughness, rx_s, ry)
    specular_dir = _to_world(col0, col1, col2, local_light)

    return jnp.where(take_diffuse[..., None], diffuse_dir, specular_dir)


def get_brdf_density(shading: ShadingInfo, sampled_dir):
    """Mixture pdf — brdf.glsl:142-150."""
    diffuse_prob = get_diffuse_sampling_probability(shading)
    specular_density = get_ggx_in_dir_density(
        shading.lambert_out,
        shading.out_dir,
        sampled_dir,
        shading.normal,
        shading.roughness,
    )
    diffuse_density = get_hemisphere_psa_density(dot(shading.normal, sampled_dir))
    return mix(specular_density, diffuse_density, diffuse_prob)
