"""Render configuration.

The static half mirrors the reference's SPIR-V specialization
constants + CLI (``main.zig:29-67``, ``RayTracingPipeline.zig:286-320``):
``num_samples`` / ``num_bounces`` / resolution / divider are
*compile-time* parameters — changing them recompiles the render
function (the XLA analog of rebuilding the RT pipeline).  The traced
half (camera vectors, frame counter) mirrors the push-constant block.

Extensions beyond the reference (all default-off so defaults match it
exactly) are grouped at the bottom.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class RenderConfig:
    # ---- reference CLI surface (same names & defaults, main.zig:29-67) ----
    num_samples: int = 1            # --num-samples / -c
    num_bounces: int = 2            # --num-bounces / -b
    resolution_x: int = 1920        # --resolution-x / -x
    resolution_y: int = 1080        # --resolution-y / -y
    render_resolution_divider: int = 1  # --render-resolution-divider / -d
    enable_validation: bool = False     # --enable-validation / -v

    # ---- extensions beyond the reference (default off) ---------------------
    progressive: bool = False       # accumulate across frames
    russian_roulette: bool = False  # RR path termination after bounce 2
    rr_start_bounce: int = 2
    # auto (GPU kernel on a GPU, XLA loop elsewhere) | bvh (XLA loop)
    # | brute (all triangles)
    traversal: str = "auto"
    # Sort bounce rays by the bounce key before traversal — pure
    # scheduling, per-ray results unchanged.
    sort_secondary: bool = True
    # True wavefront compaction: shrink the dispatch to live rays
    # between bounces (prefix-sum compaction; SURVEY.md §7 M3).
    compact_secondary: bool = False
    # Seed bounce-ray t_best with a hit from the previous bounce's
    # leaf block (valid-hit pre-pass; results unchanged). Wins in
    # interior scenes, loses slightly in open scenes — opt in.
    seed_secondary: bool = False
    ray_chunk: int = 1 << 19        # rays per dispatch chunk (0 = off)
    dtype: str = "float32"

    @property
    def render_width(self) -> int:
        return max(1, self.resolution_x // self.render_resolution_divider)

    @property
    def render_height(self) -> int:
        return max(1, self.resolution_y // self.render_resolution_divider)

    @property
    def aspect_ratio(self) -> float:
        # main.zig: camera aspect comes from the window extent.
        return self.resolution_x / self.resolution_y

    def static_key(self):
        """Everything that forces a recompile (the spec-constant set)."""
        return (
            self.num_samples,
            self.num_bounces,
            self.render_width,
            self.render_height,
            self.progressive,
            self.russian_roulette,
            self.rr_start_bounce,
            self.traversal,
            self.sort_secondary,
            self.ray_chunk,
            self.seed_secondary,
        )


# Leaf-size policy: leaf-28 blocks for scenes of at least 50k
# triangles, 14 below.  Instanced scenes pass their leaf size
# explicitly and do not consult this.
LEAF28_MIN_TRIS = 50_000


def default_max_leaf(triangle_count: int) -> int:
    """Size-keyed BVH leaf size (app + bench default; VKPT_LEAF overrides)."""
    return 28 if triangle_count >= LEAF28_MIN_TRIS else 14
