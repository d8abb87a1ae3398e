"""Kuramoto-Sivashinsky closure environment.

Parity target: ks_environment.py (module constants at :5-12, DNS setup with
transient at :18-34, episode loop, spectral reward identical in form to the
Burgers env at :98-100) with the KS solver (KS.py).

DNS recipe (ks_environment.py:18-34): simulate a transient of tTransient time
units from a noise IC, restart from the final field, then simulate tEnd-tTransient.
State features (KS.py:369-383): concat(dudx, d2udx2) with centered differences.
Reward: either pointwise -(|u - truth|) (KS.py:360-367) or the spectral
cumulative-error decrement (ks_environment.py:98-100).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.core import basis as basis_mod
from marlpde_tpu.core import ic, interp, spectral
from marlpde_tpu.envs import features
from marlpde_tpu.solvers import ks
from marlpde_tpu.utils.pytree import PyTreeNode

from functools import lru_cache


@dataclasses.dataclass(frozen=True, eq=True)
class KSEnvConfig:
    """Mirrors ks_environment.py:5-12 and run-vracer-ks.py defaults."""

    N_dns: int = 1024
    grid_size: int = 32
    num_actions: int = 32
    num_agents: int = 1
    L: float = 22.0
    dt: float = 0.25
    t_transient: float = 50.0
    t_end: float = 550.0
    episode_length: int = 500
    spectral_reward: bool = True
    dforce: bool = True
    noise: float = 0.0
    seed: int = 42
    basis_kind: str = "hat"
    reward_factor: float = 1.0
    truncation_penalty: float = -np.inf
    # LES transform backend (ks.KSConfig.fft_impl): 'fft' (jnp.fft, cuFFT on
    # the GPU) or 'dft' (real matmuls at full float32, ops/dft.py).
    fft_impl: str = "fft"

    @property
    def t_sim(self) -> float:
        return self.t_end - self.t_transient

    @property
    def n_dns_steps(self) -> int:
        return int(self.t_sim / self.dt)

    @property
    def n_intermediate(self) -> int:
        n = int(self.t_sim / self.dt / self.episode_length)
        assert n > 0
        return n

    @property
    def dns_solver(self) -> ks.KSConfig:
        return ks.KSConfig(N=self.N_dns, L=self.L, dt=self.dt)

    @property
    def les_solver(self) -> ks.KSConfig:
        return ks.KSConfig(N=self.grid_size, L=self.L, dt=self.dt,
                           dforce=self.dforce, fft_impl=self.fft_impl)

    @property
    def obs_dim(self) -> int:
        # KS.getState: concat(dudx, d2udx2) over the full grid (KS.py:369-383);
        # MARL extension: per-agent halo slices of both features
        if self.num_agents == 1:
            return 2 * self.grid_size
        return 2 * (self.grid_size // self.num_agents + 2)

    @property
    def actions_per_agent(self) -> int:
        return self.num_actions // self.num_agents


class KSDnsPool(PyTreeNode):
    uu: jax.Array        # (P, T+1, N_dns)
    spline_m: jax.Array  # (P, T+1, N_dns)
    v0_re: jax.Array     # (P, N_dns) full spectrum after transient, as a
    v0_im: jax.Array     #   float re/im pair (v0 rebuilds it on the device)
    ek_ktt: jax.Array    # (P, T+1, g//2)
    nu: jax.Array        # (P,) placeholder (KS nu == 1)

    @property
    def v0(self):
        return self.v0_re + 1j * self.v0_im


class KSEnvState(PyTreeNode):
    solver: ks.KSState
    sidx: jax.Array
    macro_step: jax.Array
    ek_sum: jax.Array
    prev_rel_err: jax.Array
    done: jax.Array
    cum_reward: jax.Array


@lru_cache(maxsize=16)
def action_basis(cfg: KSEnvConfig) -> np.ndarray:
    return basis_mod.make_basis(cfg.num_actions, cfg.grid_size, cfg.L, cfg.basis_kind)


def make_dns_pool(cfg: KSEnvConfig, n_dns: int, key=None, dtype=jnp.float32,
                  host: bool = True) -> KSDnsPool:
    """Simulate the KS DNS pool (ks_environment.py:18-34: transient from a
    noise IC, restart, then the t_end-t_transient production run).

    host=True (default): the N_dns=1024 ETDRK4 DNS integrates in float64
    numpy on the host — reference-grade fp64 ground truth and no giant
    on-device trajectory program.  host=False keeps the on-device jax build
    (used by CPU tests that need keyed jax ICs)."""
    if host:
        return _make_dns_pool_host(cfg, n_dns, dtype)
    if key is None:
        key = jax.random.key(cfg.seed)
    dcfg = cfg.dns_solver
    dx = dcfg.grid.dx

    def build(k):
        u0 = ic.ks_noise(k, cfg.N_dns, dtype)
        st = ks.init(dcfg, u0=u0)
        st, _, _ = ks.simulate(dcfg, st, int(cfg.t_transient / cfg.dt))
        # restart from transient endpoint (ks_environment.py:27-33)
        st = ks.init(dcfg, u0=st.u)
        final, uu, vv = ks.simulate(dcfg, st, cfg.n_dns_steps)
        ek_kt = spectral.energy_spectrum(vv, dx)
        ek_ktt = spectral.cumulative_mean(ek_kt, axis=0)[:, : cfg.grid_size // 2]
        m = interp.periodic_spline_m(uu)
        return dict(uu=uu, spline_m=m, v0_re=jnp.real(vv[0]),
                    v0_im=jnp.imag(vv[0]), ek_ktt=ek_ktt,
                    nu=jnp.ones((), dtype))

    keys = jax.random.split(key, n_dns)
    rows = [build(keys[i]) for i in range(n_dns)]
    stacked = {k: jnp.stack([r[k] for r in rows]) for k in rows[0]}
    return KSDnsPool(**stacked)


def _make_dns_pool_host(cfg: KSEnvConfig, n_dns: int, dtype) -> KSDnsPool:
    """Host float64 numpy ETDRK4 DNS build; literal Kassam-Trefethen update
    per KS.py:230-267 on the rfft half-spectrum (solvers/ks.py design note).
    ICs come from numpy Philox seeded [seed, i] (like the Burgers host
    build), scale 1e-3 per KS.py:173-175."""
    N, L, dt, g = cfg.N_dns, cfg.L, cfg.dt, cfg.grid_size
    dx = L / N
    E, E2, Q, f1, f2, f3, gk = ks.etdrk4_coeffs(cfg.dns_solver)
    nsteps = cfg.n_dns_steps
    n_trans = int(cfg.t_transient / cfg.dt)
    rows = []
    for i in range(n_dns):
        rng = np.random.default_rng([cfg.seed, i])
        u = 1e-3 * rng.standard_normal(N)

        def nl(z):
            uz = np.fft.irfft(z, N)
            return gk * np.fft.rfft(uz * uz)

        def etdrk4(v):
            Nv = nl(v)
            a = E2 * v + Q * Nv
            Na = nl(a)
            b = E2 * v + Q * Na
            Nb = nl(b)
            c = E2 * a + Q * (2.0 * Nb - Nv)
            Nc = nl(c)
            return E * v + Nv * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3

        rv = np.fft.rfft(u)
        for _ in range(n_trans):
            rv = etdrk4(rv)
        # restart from the transient endpoint (ks_environment.py:27-33)
        u0 = np.fft.irfft(rv, N)
        rv = np.fft.rfft(u0)
        uu = np.empty((nsteps + 1, N))
        ek_half = np.empty((nsteps + 1, g // 2))
        uu[0] = u0
        ek_half[0] = 0.5 * np.abs(rv[: g // 2]) ** 2 / N * dx
        v0_full = np.fft.fft(u0)
        for n in range(nsteps):
            rv = etdrk4(rv)
            uu[n + 1] = np.fft.irfft(rv, N)
            # Ek_kt = 0.5*|v|^2/N*dx; modes 0..g/2-1 sit identically in the
            # half spectrum (Burger.py:562 convention via full_spectrum)
            ek_half[n + 1] = 0.5 * np.abs(rv[: g // 2]) ** 2 / N * dx
        ek_ktt = np.cumsum(ek_half, 0) / np.arange(1, nsteps + 2)[:, None]
        # periodic-spline coefficients (circulant solve, interp.periodic_spline_m)
        d2 = np.roll(uu, 1, -1) - 2.0 * uu + np.roll(uu, -1, -1)
        eig = 4.0 + 2.0 * np.cos(2.0 * np.pi * np.arange(N) / N)
        m = np.real(np.fft.ifft(np.fft.fft(6.0 * d2, axis=-1) / eig, axis=-1))
        rows.append(dict(uu=uu, spline_m=m, v0_re=v0_full.real,
                         v0_im=v0_full.imag, ek_ktt=ek_ktt, nu=np.float64(1.0)))
    # dtype conversion in numpy BEFORE the device transfer
    rtype = np.float64 if dtype == jnp.float64 else np.float32
    stacked = {}
    for kname in rows[0]:
        arrs = np.stack([np.asarray(r[kname]) for r in rows])
        stacked[kname] = jax.device_put(np.ascontiguousarray(arrs.astype(rtype)))
        jax.block_until_ready(stacked[kname])
    return KSDnsPool(**stacked)


def reset(cfg: KSEnvConfig, pool: KSDnsPool, key, episode_count):
    n_pool = pool.nu.shape[0]
    sidx = jnp.asarray(episode_count % n_pool, jnp.int32)
    # per-FIELD indexing only — a whole-row gather materializes the (T+1,
    # N_dns) trajectory per env under vmap (see burger_env.reset docstring)
    dtype = pool.uu.dtype
    g = cfg.grid_size
    dns_k = jnp.asarray(cfg.dns_solver.grid.k, dtype)

    offset = jnp.zeros((), dtype)
    if cfg.noise > 0.0:
        sigma = cfg.noise * cfg.L
        lim = cfg.L / sigma
        offset = sigma * jax.random.truncated_normal(key, -lim, lim, dtype=dtype)

    v0 = jax.lax.complex(pool.v0_re[sidx], pool.v0_im[sidx])
    v0off = spectral.phase_shift(v0, offset, dns_k)
    v0 = spectral.restrict_modes(v0off, g)
    st = ks.init(cfg.les_solver, v0=v0)

    ek0 = spectral.energy_spectrum(ks.full_spectrum(st.rv, g), cfg.les_solver.grid.dx)
    state = KSEnvState(
        solver=st, sidx=sidx, macro_step=jnp.zeros((), jnp.int32),
        ek_sum=ek0, prev_rel_err=jnp.zeros((), dtype),
        done=jnp.zeros((), bool), cum_reward=jnp.zeros(cfg.num_agents, dtype))
    return state, _observe(cfg, state)


def _observe(cfg: KSEnvConfig, state: KSEnvState):
    """concat(dudx, d2udx2), centered diffs (KS.py:369-383); (na, obs) layout."""
    u = state.solver.u
    dx = cfg.les_solver.grid.dx
    up = jnp.roll(u, -1, -1)
    um = jnp.roll(u, 1, -1)
    dudx = (up - um) / (2.0 * dx)
    d2udx2 = (up - 2.0 * u + um) / dx**2
    obs = jnp.concatenate([dudx, d2udx2], axis=-1)
    if cfg.num_agents == 1:
        return obs[..., None, :]
    # per-agent halo slices of each feature, like the Burgers MARL layout
    idx = jnp.asarray(features.halo_indices(cfg.grid_size, cfg.num_agents))
    return jnp.concatenate([dudx[..., idx], d2udx2[..., idx]], axis=-1)


def step(cfg: KSEnvConfig, pool: KSDnsPool, state: KSEnvState, actions: jax.Array):
    # per-frame pool indexing (no whole-row gathers; see reset)
    dtype = state.solver.u.dtype
    lcfg = cfg.les_solver
    dx = lcfg.grid.dx
    B = jnp.asarray(action_basis(cfg), dtype)
    action_field = jnp.matmul(actions.reshape(-1), B,
                              precision=jax.lax.Precision.HIGHEST)

    def sub_step(carry, _):
        sol, ek_sum = carry
        new_sol, _aux = ks.step(lcfg, sol, action_field)
        v_full = ks.full_spectrum(new_sol.rv, cfg.grid_size)
        ek_sum = ek_sum + spectral.energy_spectrum(v_full, dx)
        return (new_sol, ek_sum), None

    (sol, ek_sum), _ = jax.lax.scan(
        sub_step, (state.solver, state.ek_sum), None, length=cfg.n_intermediate)

    if cfg.spectral_reward:
        count = (sol.ioutnum + 1).astype(dtype)
        sgs_ektt = ek_sum[1: cfg.grid_size // 2] / count
        dns_ektt = pool.ek_ktt[state.sidx, sol.ioutnum, 1: cfg.grid_size // 2]
        rel_err = jnp.mean(((jnp.abs(dns_ektt - sgs_ektt)) / dns_ektt) ** 2)
        reward = jnp.full(cfg.num_agents, cfg.reward_factor * (state.prev_rel_err - rel_err))
        new_prev = rel_err
    else:
        # pointwise -(|u - truth|) mean per agent block (KS.py:360-367)
        fidx = interp.frame_index(sol.t, cfg.dt, pool.uu.shape[1])
        x = jnp.asarray(lcfg.grid.x, dtype)
        truth = interp.periodic_spline_eval(pool.uu[state.sidx, fidx],
                                            pool.spline_m[state.sidx, fidx],
                                            x, cfg.L)
        reward = -features.agent_block_mean(jnp.abs(sol.u - truth), cfg.num_agents)
        new_prev = state.prev_rel_err

    blown = ~(jnp.isfinite(sol.u).all() & jnp.isfinite(reward).all())
    reward = jnp.where(blown, jnp.asarray(cfg.truncation_penalty, dtype), reward)

    macro = state.macro_step + 1
    done = blown | (macro >= cfg.episode_length) | state.done

    def keep_old(new, old):
        return jax.tree.map(
            lambda n, o: jnp.where(jnp.reshape(state.done, (1,) * n.ndim), o, n),
            new, old)

    sol = keep_old(sol, state.solver)
    new_state = KSEnvState(
        solver=sol, sidx=state.sidx,
        macro_step=jnp.where(state.done, state.macro_step, macro),
        ek_sum=jnp.where(state.done, state.ek_sum, ek_sum),
        prev_rel_err=jnp.where(state.done, state.prev_rel_err, new_prev),
        done=done,
        cum_reward=state.cum_reward + jnp.where(state.done, 0.0, reward))
    reward = jnp.where(state.done, jnp.zeros_like(reward), reward)
    obs = _observe(cfg, new_state)
    obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
    return new_state, obs, reward, done, dict(blown=blown)
