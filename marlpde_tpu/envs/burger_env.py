"""Burgers subgrid-closure environment: DNS ground truth, coarse LES with
per-gridpoint action forcing, MSE or spectral-energy rewards.

Parity target: burger_environment.py (episode protocol at :18-204) with the
Burger solver (Burger.py).  The reference's korali-callback episode loop
becomes a pure (reset, step) pair over immutable pytrees:

  * reset:  pick DNS from pool (episodeCount % ndns, :54-55), draw the random
    phase offset, transplant the IC (spectral restriction + phase shift :109-119
    or cubic interpolation of the truth), copy forcing tables (:99-100)
  * step:   one macro-step = nIntermediate solver sub-steps (:148-149) with the
    action field (actions @ basis) held fixed, followed by the reward:
      - MSE:       mean over sub-steps of per-agent -(truth - u)^2 means (:152-153)
      - spectral:  decrement of the cumulative-spectrum relative error
                   r_t = prevErr - err,
                   err = mean(((|Ek_dns - Ek_sgs|)/Ek_dns)[1:g/2])^2 (:172-176)
    NaN/Inf guards set done + the truncation penalty (:164-167, 181-184, 198-201)

The DNS pool is precomputed once on device (trajectory, cumulative spectrum,
spline coefficients for the cubic truth interpolant) and shared by all
vmapped envs — env state holds only the pool index.

Episodes are fixed-length (episodeLength macro-steps); `done` freezes the env.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.core import basis as basis_mod
from marlpde_tpu.core import ic, interp, spectral
from marlpde_tpu.envs import features
from marlpde_tpu.solvers import burger
from marlpde_tpu.utils.pytree import PyTreeNode


@dataclasses.dataclass(frozen=True, eq=True)
class BurgerEnvConfig:
    """Mirrors run-vracer-burger.py:5-34 defaults."""

    N_dns: int = 512
    grid_size: int = 32
    num_actions: int = 32
    num_agents: int = 1
    L: float = 2.0 * np.pi
    dt: float = 0.001
    T: float = 5.0
    nu: float = 0.02
    episode_length: int = 500
    ic_case: str = "sinus"           # 'sinus' | 'turbulence' | 'zero' | 'forced'
    spectral_reward: bool = False
    forcing: bool = False
    dforce: bool = True
    ssmforce: bool = False
    noise: float = 0.0               # offset stddev in units of L (Burger.py:54)
    seed: int = 42
    stepper: int = 1
    nunoise: bool = False
    version: int = 0
    ssm: bool = False
    dsm: bool = False
    basis_kind: str = "hat"          # burger_environment.py:9
    scheme: str = "abcn"             # 'fd' gives the Burger_fd env
    reward_factor: float = 1.0
    truncation_penalty: float = -np.inf   # burger_environment.py:200
    coupled: bool = False            # baseline-relative reward (coupled_burger_environment.py)
    dns_mode: str = "pool"           # 'pool' | 'lockstep' (fresh DNS per episode,
                                     # advanced alongside the LES — the nunoise
                                     # path of burger_environment.py:57-75)
    state_bound: float = np.inf      # |state| sanity bound; the FD env truncates
                                     # at 1e6 (burger_fd_environment.py:165)
    fft_impl: str = "fft"            # LES transform impl: 'fft' | 'dft' (matmul)

    @property
    def n_dns_steps(self) -> int:
        return int(self.T / self.dt)

    @property
    def n_intermediate(self) -> int:
        n = int(self.T / self.dt / self.episode_length)
        assert n > 0, "dt or episodeLength too long (burger_environment.py:130)"
        return n

    @property
    def dns_solver(self) -> burger.BurgerConfig:
        return burger.BurgerConfig(N=self.N_dns, L=self.L, dt=self.dt, nu=self.nu,
                                   stepper=self.stepper, forcing=self.forcing)

    @property
    def les_solver(self) -> burger.BurgerConfig:
        return burger.BurgerConfig(N=self.grid_size, L=self.L, dt=self.dt, nu=self.nu,
                                   stepper=self.stepper, forcing=self.forcing,
                                   dforce=self.dforce, ssmforce=self.ssmforce,
                                   ssm=self.ssm, dsm=self.dsm, scheme=self.scheme,
                                   fft_impl=self.fft_impl)

    @property
    def obs_dim(self) -> int:
        return features.obs_dim(self.version, self.grid_size, self.num_agents)

    @property
    def actions_per_agent(self) -> int:
        return self.num_actions // self.num_agents


class DnsPool(PyTreeNode):
    """Precomputed DNS ground truth shared by all envs (leading axis = pool).

    The IC spectrum is stored as a float re/im pair (``v0`` below rebuilds
    the complex value on the device).
    """

    uu: jax.Array        # (P, T+1, N_dns) trajectory
    spline_m: jax.Array  # (P, T+1, N_dns) periodic-spline coefficients of uu
    v0_re: jax.Array     # (P, N_dns) IC spectrum, real part
    v0_im: jax.Array     # (P, N_dns) IC spectrum, imaginary part
    ek_ktt: jax.Array    # (P, T+1, g//2) cumulative-mean spectrum, cols 0..g/2-1
    nu: jax.Array        # (P,)
    randfac1: jax.Array  # (P, 4, s)
    randfac2: jax.Array  # (P, 4, s)
    # DNS truth pre-restricted to the LES grid (P, T+1, g) — the reference's
    # setGroundTruth pattern (Burger.py:322-327: interpolate the truth once,
    # query per step).  Built for MSE-reward configs with N_dns % g == 0, where
    # the LES gridpoints coincide with every (N_dns/g)-th DNS point and the
    # cubic spline is exact at its knots; the per-substep reward then gathers
    # g floats instead of spline-evaluating against two (T+1, N_dns) arrays.
    truth_les: jax.Array | None = None

    @property
    def v0(self):
        return self.v0_re + 1j * self.v0_im


class BurgerEnvState(PyTreeNode):
    solver: burger.BurgerState
    u_prev: jax.Array        # previous sub-step field (for the dudt feature)
    sidx: jax.Array          # int32 DNS pool index
    macro_step: jax.Array    # int32
    ek_sum: jax.Array        # (g,) running sum of LES Ek_kt incl. IC frame
    prev_rel_err: jax.Array  # scalar
    done: jax.Array          # bool
    cum_reward: jax.Array    # (num_agents,)


@lru_cache(maxsize=32)
def action_basis(cfg: BurgerEnvConfig) -> np.ndarray:
    return basis_mod.make_basis(cfg.num_actions, cfg.grid_size, cfg.L, cfg.basis_kind)


def _wants_truth_les(cfg: BurgerEnvConfig) -> bool:
    """Pool carries the pre-restricted truth channel (see DnsPool.truth_les)
    when the MSE reward needs per-substep truth and the grids nest exactly."""
    return (not cfg.spectral_reward and not cfg.coupled
            and cfg.N_dns % cfg.grid_size == 0)


def _dns_ic(cfg: BurgerEnvConfig, seed, key, dtype):
    g = cfg.dns_solver.grid
    x = jnp.asarray(g.x, dtype)
    if cfg.ic_case == "sinus":
        return ic.burger_sinus(0.0, x, cfg.L)
    if cfg.ic_case == "turbulence":
        return ic.burger_turbulence(seed, 0.0, x, cfg.L, dtype=dtype)
    if cfg.ic_case == "zero":
        return jnp.zeros(cfg.N_dns, dtype)
    if cfg.ic_case == "forced":
        return ic.burger_forced(key, x, cfg.L)
    raise ValueError(f"[burger_env] unknown ic {cfg.ic_case}")


def make_dns_pool(cfg: BurgerEnvConfig, n_dns: int, key=None,
                  dtype=jnp.float32, host: bool = True) -> DnsPool:
    """Simulate the DNS pool (burger_environment.py:11-16, seeds seed+i per
    run-vracer-burger.py:47) and precompute reward/interp tables.

    host=True (default): the DNS integrates in float64 numpy on the host —
    a once-per-run cost that gives reference-grade fp64 ground truth even when
    the device envs run fp32, and keeps the big 5000-step trajectory compile off
    the device.  host=False runs the same build fully on-device (jax).
    """
    if key is None:
        key = jax.random.key(cfg.seed)
    if host:
        return _make_dns_pool_host(cfg, n_dns, key, dtype)
    dcfg = cfg.dns_solver
    g = dcfg.grid
    dx = g.dx

    def build(i, k):
        kf, kn, kic = jax.random.split(k, 3)
        rf1, rf2 = burger.draw_forcing_tables(kf, cfg.stepper, dtype)
        nu = jnp.asarray(cfg.nu, dtype)
        if cfg.nunoise:
            nu = 0.01 + 0.02 * jax.random.uniform(kn, dtype=dtype)
        u0 = _dns_ic(cfg, cfg.seed + i, kic, dtype)
        st = burger.init(dcfg, u0=u0, nu=nu, randfac1=rf1, randfac2=rf2)
        _, uu, vv = burger.simulate(dcfg, st, cfg.n_dns_steps)
        ek_kt = spectral.energy_spectrum(vv, dx)
        ek_ktt = spectral.cumulative_mean(ek_kt, axis=0)[:, : cfg.grid_size // 2]
        m = interp.periodic_spline_m(uu)
        row = dict(uu=uu, spline_m=m, v0_re=jnp.real(vv[0]),
                   v0_im=jnp.imag(vv[0]), ek_ktt=ek_ktt, nu=nu,
                   randfac1=rf1, randfac2=rf2)
        if _wants_truth_les(cfg):
            row["truth_les"] = uu[:, :: cfg.N_dns // cfg.grid_size]
        return row

    keys = jax.random.split(key, n_dns)
    rows = [build(i, keys[i]) for i in range(n_dns)]
    stacked = {k: jnp.stack([r[k] for r in rows]) for k in rows[0]}
    return DnsPool(**stacked)


def _make_dns_pool_host(cfg: BurgerEnvConfig, n_dns: int, key, dtype) -> DnsPool:
    """Host float64 numpy DNS build; literal ABCN per Burger.py:482-489."""
    dcfg = cfg.dns_solver
    N, L, dt = cfg.N_dns, cfg.L, cfg.dt
    k = np.fft.fftfreq(N, L / (2 * np.pi * N))
    k1 = 1j * k
    x = np.linspace(0, L, N, endpoint=False)
    nsteps = cfg.n_dns_steps
    rows = []
    del key  # the host build is fully device-free; tables/nu come from
    # numpy Philox seeded by (seed, i)
    for i in range(n_dns):
        hrng = np.random.default_rng([cfg.seed, i])
        rf1 = hrng.standard_normal((4, cfg.stepper))
        rf2 = hrng.standard_normal((4, cfg.stepper))
        nu = cfg.nu
        if cfg.nunoise:
            nu = 0.01 + 0.02 * float(hrng.uniform())
        if cfg.ic_case == "turbulence":
            u0 = ic.burger_turbulence_numpy(cfg.seed + i, 0.0, x, L)
        elif cfg.ic_case == "sinus":
            u0 = np.sin(4.0 * np.pi * x / L)
        elif cfg.ic_case == "zero":
            u0 = np.zeros(N)
        elif cfg.ic_case == "forced":
            u0 = ic.burger_forced_numpy(cfg.seed + i, x, L)
        elif cfg.ic_case == "box":
            # Burger_jax.py:215-216 (enabled there; Burger.py:218 disables it
            # with `assert False` — documented reference quirk)
            u0 = (np.abs(x - L / 2) < L / 8).astype(float)
        elif cfg.ic_case == "gaussian":
            # Burger_jax.py:15-16,208-213: normalized pdf, mean L/2, sigma L/8
            sigma = L / 8
            u0 = (np.exp(-0.5 * ((x - 0.5 * L) / sigma) ** 2)
                  / np.sqrt(2 * np.pi * sigma ** 2))
        else:
            raise ValueError(f"[burger_env] unknown ic {cfg.ic_case}")
        uu = np.empty((nsteps + 1, N))
        vv = np.empty((nsteps + 1, N), complex)
        u = u0.copy()
        v = np.fft.fft(u0)
        uu[0], vv[0] = u, v
        fn_old = k1 * np.fft.fft(0.5 * u0 * u0)
        C = 0.5 * (k**2) * nu * dt
        if cfg.forcing:
            # precompute the stepper-cycled forcing spectra (Burger.py:410-421)
            A = np.sqrt(2.0) / L
            fcols = np.zeros((cfg.stepper, N))
            for ridx in range(cfg.stepper):
                for kk in range(1, 4):
                    fcols[ridx] += (rf1[kk, ridx] * A
                                    / np.sqrt(kk * cfg.stepper * dt)
                                    * np.cos(2 * np.pi * kk * x / L
                                             + 2 * np.pi * rf2[kk, ridx]))
            fcols_hat = np.fft.fft(fcols, axis=-1)
        for n in range(nsteps):
            F = fcols_hat[n % cfg.stepper] if cfg.forcing else 0.0
            Fn = k1 * np.fft.fft(0.5 * u * u)
            v = ((1.0 - C) * v - 0.5 * dt * (3.0 * Fn - fn_old) + dt * F) / (1.0 + C)
            fn_old = Fn
            u = np.real(np.fft.ifft(v))
            uu[n + 1], vv[n + 1] = u, v
        ek_kt = 0.5 * np.abs(vv) ** 2 / N * (L / N)
        ek_ktt = (np.cumsum(ek_kt, 0)
                  / np.arange(1, nsteps + 2)[:, None])[:, : cfg.grid_size // 2]
        # periodic-spline coefficients (circulant solve, interp.periodic_spline_m)
        d2 = np.roll(uu, 1, -1) - 2.0 * uu + np.roll(uu, -1, -1)
        eig = 4.0 + 2.0 * np.cos(2.0 * np.pi * np.arange(N) / N)
        m = np.real(np.fft.ifft(np.fft.fft(6.0 * d2, axis=-1) / eig, axis=-1))
        row = dict(uu=uu, spline_m=m, v0_re=vv[0].real, v0_im=vv[0].imag,
                   ek_ktt=ek_ktt, nu=nu, randfac1=rf1, randfac2=rf2)
        if _wants_truth_les(cfg):
            row["truth_les"] = uu[:, :: N // cfg.grid_size]
        rows.append(row)
    # convert dtypes in numpy BEFORE the device transfer: moving f64 data to
    # the device only to convert it there doubles the transfer
    rtype = np.float64 if dtype == jnp.float64 else np.float32
    stacked = {}
    for kname in rows[0]:
        arrs = np.stack([r[kname] for r in rows])
        try:
            stacked[kname] = jax.device_put(np.ascontiguousarray(arrs.astype(rtype)))
            jax.block_until_ready(stacked[kname])
        except Exception as e:
            raise RuntimeError(
                f"[make_dns_pool] device transfer failed for '{kname}' "
                f"shape={arrs.shape} dtype={rtype}") from e
    return DnsPool(**stacked)


def _pool_row(pool: DnsPool, sidx):
    return jax.tree.map(lambda a: a[sidx], pool)


def _draw_offset(cfg: BurgerEnvConfig, key, dtype):
    """offset ~ N(0, noise*L) conditioned on |offset| <= L (Burger.py:53-57)."""
    if cfg.noise <= 0.0:
        return jnp.zeros((), dtype)
    sigma = cfg.noise * cfg.L
    lim = cfg.L / sigma
    return sigma * jax.random.truncated_normal(key, -lim, lim, dtype=dtype)


def reset(cfg: BurgerEnvConfig, pool: DnsPool, key, episode_count):
    """Start an episode; returns (state, obs).

    Pool fields are indexed per-FIELD (and per-frame where a frame suffices),
    never via a whole-row gather: under vmap a row gather materializes the
    episode's entire (T+1, N_dns) trajectory per env — 20 MB/env at the
    burger-fd config, the round-3 42 GB OOM (runs/bench_fd_r3.log)."""
    n_pool = pool.nu.shape[0]
    sidx = jnp.asarray(episode_count % n_pool, jnp.int32)
    dtype = pool.uu.dtype
    offset = _draw_offset(cfg, key, dtype)
    lcfg = cfg.les_solver
    g = cfg.grid_size
    nu = pool.nu[sidx]
    rf1, rf2 = pool.randfac1[sidx], pool.randfac2[sidx]

    dns_k = jnp.asarray(cfg.dns_solver.grid.k, dtype)
    if cfg.spectral_reward:
        # spectral restriction + phase shift (burger_environment.py:110-112)
        v0 = jax.lax.complex(pool.v0_re[sidx], pool.v0_im[sidx])
        v0off = spectral.phase_shift(v0, offset, dns_k)
        v0 = spectral.restrict_modes(v0off, g)
        st = burger.init(lcfg, v0=v0, nu=nu, offset=offset,
                         randfac1=rf1, randfac2=rf2)
    else:
        # interpolate the truth at the shifted coarse grid (burger_environment.py:114-119)
        newx = interp.shifted_query_points(
            jnp.asarray(lcfg.grid.x, dtype), offset, cfg.L)
        u0 = interp.periodic_spline_eval(pool.uu[sidx, 0], pool.spline_m[sidx, 0],
                                         newx, cfg.L)
        st = burger.init(lcfg, u0=u0, nu=nu, offset=offset,
                         randfac1=rf1, randfac2=rf2)

    ek0 = spectral.energy_spectrum(st.v, lcfg.grid.dx)
    state = BurgerEnvState(
        solver=st, u_prev=st.u, sidx=sidx,
        macro_step=jnp.zeros((), jnp.int32),
        ek_sum=ek0,
        prev_rel_err=jnp.zeros((), dtype),
        done=jnp.zeros((), bool),
        cum_reward=jnp.zeros(cfg.num_agents, dtype))
    return state, _observe(cfg, state)


def _observe(cfg: BurgerEnvConfig, state: BurgerEnvState):
    return features.burger_features(
        cfg.version, cfg.num_agents, state.solver.u, state.u_prev,
        state.solver.v, cfg.dt, cfg.les_solver.grid.dx)


def _mse_rewards(cfg: BurgerEnvConfig, pool: DnsPool, sidx, solver_state):
    """Per-agent -(truth(x+offset, t) - u)^2 means (Burger.py:578-601).

    Offset-free configs read the pre-restricted truth channel — one (g,)
    gather per substep (DnsPool.truth_les, the setGroundTruth layout).  With
    a per-episode offset the queries fall between DNS knots, so the frame is
    gathered and spline-evaluated; see the reset docstring for why whole-ROW
    (T+1, N_dns) gathers are forbidden either way."""
    fidx = interp.frame_index(solver_state.t, cfg.dt, pool.uu.shape[1])
    if cfg.noise == 0.0 and pool.truth_les is not None:
        truth = pool.truth_les[sidx, fidx]
        sq = (truth - solver_state.u) ** 2
        return -features.agent_block_mean(sq, cfg.num_agents)
    return _mse_from_frame(cfg, pool.uu[sidx, fidx], pool.spline_m[sidx, fidx],
                           solver_state)


def _mse_from_frame(cfg: BurgerEnvConfig, frame_u, frame_m, solver_state):
    """MSE reward against an already-materialized DNS frame.

    Uniform-grid fast path: the queries are x_coarse + offset, so the spline
    eval is one contiguous dynamic-slice instead of 4 gathers (this op runs
    every SUBSTEP of the burger-fd env)."""
    truth = interp.periodic_spline_eval_uniform(
        frame_u, frame_m, solver_state.offset, cfg.L, cfg.grid_size)
    sq = (truth - solver_state.u) ** 2
    return -features.agent_block_mean(sq, cfg.num_agents)


def step(cfg: BurgerEnvConfig, pool: DnsPool, state: BurgerEnvState,
         actions: jax.Array):
    """One macro-step.  actions: (num_agents, actions_per_agent) or (num_actions,).

    Returns (state, obs, reward (num_agents,), done, info).
    """
    dtype = state.solver.u.dtype
    lcfg = cfg.les_solver
    dx = lcfg.grid.dx
    B = jnp.asarray(action_basis(cfg), dtype)
    # Burger.py:437,442; full float32 (no TF32) like every solver matmul
    action_field = jnp.matmul(actions.reshape(-1), B,
                              precision=jax.lax.Precision.HIGHEST)

    def sub_step(carry, _):
        sol, ek_sum, mse_acc, u_prev = carry
        new_sol, _aux = burger.step(lcfg, sol, action_field)
        ek_sum = ek_sum + spectral.energy_spectrum(new_sol.v, dx)
        if not cfg.spectral_reward:
            # NB: per-substep (sidx, fidx) ROW gathers measured FASTER than
            # prefetching the macro-step's 10 consecutive frames as one
            # (1, 10, 1024) dynamic-slice block (488.7k vs 231.3k substeps/s,
            # runs/bench_fd_r4b.log vs bench_fd_r4c.log) — batched
            # multi-dim dynamic_slice lowers worse than row gathers here.
            mse_acc = mse_acc + _mse_rewards(cfg, pool, state.sidx,
                                             new_sol) / cfg.n_intermediate
        return (new_sol, ek_sum, mse_acc, sol.u), None

    init_carry = (state.solver, state.ek_sum,
                  jnp.zeros(cfg.num_agents, dtype), state.u_prev)
    (sol, ek_sum, mse_acc, u_prev), _ = jax.lax.scan(
        sub_step, init_carry, None, length=cfg.n_intermediate)

    if cfg.coupled:
        # baseline-relative reward (coupled_burger_environment.py:76-128):
        # re-run this macro-step uncontrolled with explicit-Euler spectral
        # updates from the pre-step LES field, reward = baseMSE - lesMSE
        k1 = jnp.asarray(lcfg.grid.k1, state.solver.v.dtype)
        k2 = jnp.asarray(lcfg.grid.k2, state.solver.v.dtype)
        nu = state.solver.nu[..., None]

        def base_sub(carry, _):
            ub, vb = carry
            vb = vb - cfg.dt * 0.5 * k1 * spectral.fft(ub * ub) + cfg.dt * nu * k2 * vb
            return (spectral.irfft_real(vb), vb), None

        (u_base, _), _ = jax.lax.scan(
            base_sub, (state.solver.u, state.solver.v), None,
            length=cfg.n_intermediate)
        newx = jnp.asarray(lcfg.grid.x, dtype)
        fidx = interp.frame_index(sol.t, cfg.dt, pool.uu.shape[1])
        truth = interp.periodic_spline_eval(pool.uu[state.sidx, fidx],
                                            pool.spline_m[state.sidx, fidx],
                                            newx, cfg.L)
        les_mse = jnp.mean((truth - sol.u) ** 2)
        base_mse = jnp.mean((truth - u_base) ** 2)
        reward = jnp.full(cfg.num_agents,
                          cfg.reward_factor * (base_mse - les_mse))
        new_prev = state.prev_rel_err
    elif cfg.spectral_reward:
        # cumulative-mean spectra at the current LES step (burger_environment.py:172-176)
        count = (sol.ioutnum + 1).astype(dtype)
        sgs_ektt = ek_sum[1: cfg.grid_size // 2] / count
        dns_ektt = pool.ek_ktt[state.sidx, sol.ioutnum, 1: cfg.grid_size // 2]
        rel_err = jnp.mean(((jnp.abs(dns_ektt - sgs_ektt)) / dns_ektt) ** 2)
        reward = jnp.full(cfg.num_agents, cfg.reward_factor * (state.prev_rel_err - rel_err))
        new_prev = rel_err
    else:
        reward = cfg.reward_factor * mse_acc
        new_prev = state.prev_rel_err

    obs_ok = jnp.isfinite(sol.u).all()
    if np.isfinite(cfg.state_bound):
        obs_ok = obs_ok & (jnp.abs(sol.u).max() <= cfg.state_bound)
    rew_ok = jnp.isfinite(reward).all()
    blown = ~(obs_ok & rew_ok)
    reward = jnp.where(blown, jnp.asarray(cfg.truncation_penalty, dtype), reward)

    macro = state.macro_step + 1
    done = blown | (macro >= cfg.episode_length) | state.done

    # freeze everything once done (fixed-length rollouts with masking)
    def keep_old(new, old):
        return jax.tree.map(
            lambda n, o: jnp.where(
                jnp.reshape(state.done, (1,) * n.ndim), o, n), new, old)

    sol = keep_old(sol, state.solver)
    new_state = BurgerEnvState(
        solver=sol, u_prev=jnp.where(state.done, state.u_prev, u_prev),
        sidx=state.sidx, macro_step=jnp.where(state.done, state.macro_step, macro),
        ek_sum=jnp.where(state.done, state.ek_sum, ek_sum),
        prev_rel_err=jnp.where(state.done, state.prev_rel_err, new_prev),
        done=done,
        cum_reward=state.cum_reward + jnp.where(state.done, 0.0, reward))
    reward = jnp.where(state.done, jnp.zeros_like(reward), reward)
    obs = _observe(cfg, new_state)
    obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
    return new_state, obs, reward, done, dict(blown=blown)


# ----------------------------------------------------------- lockstep-DNS mode

class BurgerLockstepState(PyTreeNode):
    """Env state carrying its own DNS, advanced alongside the LES.

    The reference rebuilds a full DNS per episode under nunoise
    (burger_environment.py:57-75), storing the whole trajectory.  With
    thousands of vmapped envs on one device that is O(T*N_dns) memory per env; running the
    DNS in lockstep keeps it O(N_dns) and exact."""

    les: burger.BurgerState
    dns: burger.BurgerState
    u_prev: jax.Array
    macro_step: jax.Array
    ek_sum: jax.Array          # LES running spectrum sum
    dns_ek_sum: jax.Array      # DNS running spectrum sum, first g//2 cols
    prev_rel_err: jax.Array
    done: jax.Array
    cum_reward: jax.Array


def reset_lockstep(cfg: BurgerEnvConfig, consts, key, episode_count):
    """Fresh DNS per episode: nu ~ U(0.01, 0.03) under nunoise (Burger.py:89),
    turbulence seed = cfg.seed + episode_count (vmappable)."""
    del consts
    k_nu, k_off, k_f = jax.random.split(key, 3)
    dtype = jnp.float32 if not jax.config.jax_enable_x64 else jnp.float64
    dcfg, lcfg = cfg.dns_solver, cfg.les_solver
    g = cfg.grid_size

    nu = jnp.asarray(cfg.nu, dtype)
    if cfg.nunoise:
        nu = 0.01 + 0.02 * jax.random.uniform(k_nu, dtype=dtype)
    offset = _draw_offset(cfg, k_off, dtype)

    x_d = jnp.asarray(dcfg.grid.x, dtype)
    tseed = cfg.seed + episode_count
    if cfg.ic_case == "turbulence":
        u0_d = ic.burger_turbulence(tseed, 0.0, x_d, cfg.L, dtype=dtype)
    elif cfg.ic_case == "sinus":
        u0_d = ic.burger_sinus(0.0, x_d, cfg.L)
    else:
        u0_d = jnp.zeros(cfg.N_dns, dtype)
    rf1, rf2 = burger.draw_forcing_tables(k_f, cfg.stepper, dtype)
    dns = burger.init(dcfg, u0=u0_d, nu=nu, randfac1=rf1, randfac2=rf2)

    dns_k = jnp.asarray(dcfg.grid.k, dtype)
    v0off = spectral.phase_shift(dns.v, offset, dns_k)
    v0 = spectral.restrict_modes(v0off, g)
    les = burger.init(lcfg, v0=v0, nu=nu, offset=offset,
                      randfac1=rf1, randfac2=rf2)

    state = BurgerLockstepState(
        les=les, dns=dns, u_prev=les.u,
        macro_step=jnp.zeros((), jnp.int32),
        ek_sum=spectral.energy_spectrum(les.v, lcfg.grid.dx),
        dns_ek_sum=spectral.energy_spectrum(dns.v, dcfg.grid.dx)[: g // 2],
        prev_rel_err=jnp.zeros((), dtype),
        done=jnp.zeros((), bool),
        cum_reward=jnp.zeros(cfg.num_agents, dtype))
    obs = features.burger_features(cfg.version, cfg.num_agents, les.u, les.u,
                                   les.v, cfg.dt, lcfg.grid.dx)
    return state, obs


def step_lockstep(cfg: BurgerEnvConfig, consts, state: BurgerLockstepState,
                  actions: jax.Array):
    """Macro-step advancing DNS and LES together; rewards as in `step`.

    MSE reward interpolates the *current* DNS field (cubic periodic spline on
    the fly); spectral reward uses running cumulative-mean spectra on both
    sides (identical in value to the pool path, since the DNS trajectory index
    always equals the LES step index)."""
    del consts
    dtype = state.les.u.dtype
    dcfg, lcfg = cfg.dns_solver, cfg.les_solver
    dx_l, dx_d = lcfg.grid.dx, dcfg.grid.dx
    g = cfg.grid_size
    B = jnp.asarray(action_basis(cfg), dtype)
    action_field = jnp.matmul(actions.reshape(-1), B,
                              precision=jax.lax.Precision.HIGHEST)

    def sub(carry, _):
        les, dns, ek_sum, dns_ek, mse_acc, u_prev = carry
        new_les, _ = burger.step(lcfg, les, action_field)
        new_dns, _ = burger.step(dcfg, dns)
        ek_sum = ek_sum + spectral.energy_spectrum(new_les.v, dx_l)
        dns_ek = dns_ek + spectral.energy_spectrum(new_dns.v, dx_d)[: g // 2]
        if not cfg.spectral_reward:
            newx = interp.shifted_query_points(
                jnp.asarray(lcfg.grid.x, dtype), new_les.offset, cfg.L)
            truth = interp.cubic_interp(new_dns.u, newx, cfg.L)
            sq = (truth - new_les.u) ** 2
            mse_acc = mse_acc - features.agent_block_mean(sq, cfg.num_agents) \
                / cfg.n_intermediate
        return (new_les, new_dns, ek_sum, dns_ek, mse_acc, les.u), None

    init_carry = (state.les, state.dns, state.ek_sum, state.dns_ek_sum,
                  jnp.zeros(cfg.num_agents, dtype), state.u_prev)
    (les, dns, ek_sum, dns_ek, mse_acc, u_prev), _ = jax.lax.scan(
        sub, init_carry, None, length=cfg.n_intermediate)

    if cfg.spectral_reward:
        count = (les.ioutnum + 1).astype(dtype)
        sgs_ektt = ek_sum[1: g // 2] / count
        dns_ektt = dns_ek[1: g // 2] / count
        rel_err = jnp.mean(((jnp.abs(dns_ektt - sgs_ektt)) / dns_ektt) ** 2)
        reward = jnp.full(cfg.num_agents,
                          cfg.reward_factor * (state.prev_rel_err - rel_err))
        new_prev = rel_err
    else:
        reward = cfg.reward_factor * mse_acc
        new_prev = state.prev_rel_err

    blown = ~(jnp.isfinite(les.u).all() & jnp.isfinite(reward).all())
    reward = jnp.where(blown, jnp.asarray(cfg.truncation_penalty, dtype), reward)
    macro = state.macro_step + 1
    done = blown | (macro >= cfg.episode_length) | state.done

    keep = lambda n, o: jax.tree.map(
        lambda a_, b_: jnp.where(jnp.reshape(state.done, (1,) * a_.ndim), b_, a_),
        n, o)
    les = keep(les, state.les)
    dns = keep(dns, state.dns)
    new_state = BurgerLockstepState(
        les=les, dns=dns,
        u_prev=jnp.where(state.done, state.u_prev, u_prev),
        macro_step=jnp.where(state.done, state.macro_step, macro),
        ek_sum=jnp.where(state.done, state.ek_sum, ek_sum),
        dns_ek_sum=jnp.where(state.done, state.dns_ek_sum, dns_ek),
        prev_rel_err=jnp.where(state.done, state.prev_rel_err, new_prev),
        done=done,
        cum_reward=state.cum_reward + jnp.where(state.done, 0.0, reward))
    reward = jnp.where(state.done, jnp.zeros_like(reward), reward)
    obs = features.burger_features(cfg.version, cfg.num_agents, les.u,
                                   new_state.u_prev, les.v, cfg.dt, dx_l)
    obs = jnp.where(jnp.isfinite(obs), obs, 0.0)
    return new_state, obs, reward, done, dict(blown=blown)
