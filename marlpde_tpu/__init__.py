"""marlpde_tpu: JAX framework for RL-based subgrid-scale closure modeling of 1D PDEs.

A from-scratch JAX/XLA re-design of the capabilities of wadaniel/marlpde:
vectorized PDE environment engine
(diffusion, advection, viscous/stochastic Burgers, Kuramoto-Sivashinsky; FD and
pseudo-spectral variants; ABCN / RK3 / ETDRK4 integrators), per-gridpoint
multi-agent closure-correction interface, and a JAX-native VRACER learner
(clipped-normal policy, REFER replay) replacing the reference's external korali
C++ engine.

Design stance (vs. the reference's object-per-simulation, history-array,
callback-driven design):
  * pure ``step(cfg, state, forcing) -> state`` functions over immutable pytrees
  * an env-batch leading axis under ``vmap``; ``lax.scan`` for time
  * ``jax.random`` keys threaded explicitly
  * on-device rollouts: policy net inside the scan body, no host ping-pong
  * sharded env batches + data-parallel learner over a ``jax.sharding.Mesh``
"""

__version__ = "0.1.0"

from marlpde_tpu.core import grids, spectral, basis, ic, interp  # noqa: F401
