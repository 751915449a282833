"""husky_rover_mppi_isaacsim_torch — the MPPI rover-navigation framework in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``husky_rover_mppi_isaacsim_tpu`` (the JAX reference, which stays
beside it), slice by slice. It imports torch, numpy and scipy, never jax, and the
layout mirrors the JAX package's:

- ``core``      — heightfield geometry: corner gathers, bilinear height, quad
                  normals, tangent projection, Rodrigues heading updates.
- ``dynamics``  — Husky skid-steer wheel-lag model and diff-drive map.
- ``mppi``      — sampling, 2.5D/2D rollouts, critics, the control step,
                  the goal-seek loops and the 2D-vs-3D evaluation.
- ``ops``       — kernels and the ops behind them: the CUDA rollout (K1),
                  the exact EDT with its CUDA min-plus envelope (K2), and
                  their build.
- ``terrain``   — crater surface, the 750-obstacle costmap, the
                  small-scale procedural terrain (base noise + craters) and
                  the streamed terrain.
- ``env``       — the rover simulator, the closed loop, the streamed loop and
                  the named-robot registry.
- ``shell``     — the host shell: message bus, rate, monitor and the
                  simulation manager.
- ``parallel``  — sample and rover sharding over ``torch.distributed``.
- ``physics``   — wheel-track deformation, terramechanics, the scene config.
- ``aux``       — the configuration tree (its own YAML reader), SDG
                  labeling, render post-effects, stellar lighting,
                  checkpoints, plots.
- ``utils``     — the scoped timer.
- ``convert``   — JAX-side state (as numpy) into this package's objects.
- ``cli``       — ``python -m husky_rover_mppi_isaacsim_torch.cli``, reading
                  ``cfg/`` as ``run.py`` does.
"""

__version__ = "0.1.0"
