"""Ray-sphere intersection constants (reference raytracer.wgsl:7-8).

Counterpart of weekend_raytracer_tpu/ops/intersect.py. Only the hit-range
constants are ported so far; the fused kernel carries its own closest-hit
sweep (csrc/megakernel.cu), and the XLA-style vectorized intersector waits
for the ``"xla"`` backend.
"""
MIN_T = 1.0e-3  # raytracer.wgsl:7
MAX_T = 1.0e3  # raytracer.wgsl:8
