"""Runtime validation — the Vulkan-validation-layer analog.

The reference's ``--enable-validation`` turns on
VK_LAYER_KHRONOS_validation (GraphicsContext.zig:91-126); Zig
ReleaseSafe adds bounds/overflow checks.  The equivalents here,
bundled behind the same flag:

- ``jax_debug_nans`` (app/main.py) — NaN/Inf tripwires in every
  compiled function.
- Host BVH invariant validation (ops/bvh.validate_bvh).
- ``checked_render`` here: a jax.experimental.checkify pass over one
  representative render step with index OOB + NaN + div-by-zero
  checks enabled — the analog of a validation-layer smoke dispatch.
  Gather/scatter index errors inside the wavefront (hit decode,
  material rows, texel pool) surface as typed errors instead of
  silently clamping.
"""

from __future__ import annotations


def checked_render(scene, camera, config, width: int = 64,
                   height: int = 64):
    """Run one small render frame under checkify with index/NaN/div
    checks; raises on any violation, returns the image otherwise.

    Uses the XLA traversal path (checkify cannot see inside Pallas
    kernels; the kernel's invariants are covered by the kernel-vs-XLA
    parity tests)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import checkify

    from vulkan_pathtracer_tpu.render.pipeline import render_frame

    position, horizontal, vertical, forward = (
        jnp.asarray(v) for v in camera.push_constants()
    )

    def step(scene, position, horizontal, vertical, forward, frame):
        return render_frame(
            scene, position, horizontal, vertical, forward, frame,
            num_samples=1,
            num_bounces=min(config.num_bounces, 2),
            width=width, height=height,
            traversal="bvh" if scene.has_bvh else "brute",
            russian_roulette=config.russian_roulette,
            rr_start_bounce=config.rr_start_bounce,
            sort_secondary=False,
        )

    checked = checkify.checkify(
        jax.jit(step),
        errors=checkify.index_checks | checkify.nan_checks
        | checkify.div_checks,
    )
    err, (image, rays) = checked(
        scene, position, horizontal, vertical, forward, jnp.uint32(0)
    )
    err.throw()
    return image
