"""Reference comparisons and timings of the device path, at any size.

``chip_smoke.py`` runs these on the GPU at the flagship widths; the CPU tests
run them at tiny sizes (tests/test_chip_checks.py).  Each comparison advances
the device path in float32 and an independent float64 numpy re-derivation of
the same equations from the same initial state, and returns the worst error
of every compared quantity beside its limit:

    {"name": ..., "errors": {q: worst}, "limits": {q: limit}, "ok": bool}

Timings end every measured call in ``jax.block_until_ready``.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

# Limits, relative to the scale of each quantity (max |reference|).  float32
# carries ~6e-8 relative round-off per operation; an N=32 FFT adds log2(32)
# roundings, and 50 ABCN sub-steps (5 macro-steps) accumulate them.  On the
# CPU (pocketfft) the flagship turbulence case measures u 2.2e-6, ek_sum
# 8e-7 and reward 3.3e-5; the limits leave ~10x headroom for another
# summation order (cuFFT), and u and ek_sum sit well below the ~1e-3 that
# TF32 transforms (10-bit mantissa) would give, so an unpinned solver matmul
# fails the check.  The reward is a difference of squared relative spectrum
# errors over modes whose DNS energy spans decades, so round-off in the
# small modes is amplified; it is measured against the relative error's
# own scale.
BURGERS_LIMITS = {"u": 3e-5, "ek_sum": 1e-5, "reward": 3e-4}
# KS is chaotic: round-off differences grow by the leading Lyapunov exponent
# (~0.05 per time unit at L=22), so pointwise agreement is checked only over
# the first 10 macro-steps (t <= 10), and after that the time-mean energy and
# spectrum, which chaos leaves invariant.  Spectrum modes below 1e-6 of the
# peak are round-off themselves and are not compared.  The CPU measures
# 3.6e-7 / 5.9e-7 / 3.0e-6 at N_dns=1024; the limits leave >=25x headroom.
KS_LIMITS = {"u_first_steps": 1e-5, "energy": 1e-4, "spectrum": 1e-3}
KS_POINTWISE_STEPS = 10


def _worst(dev, ref):
    """Worst absolute error over the scale of the reference."""
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    return float(np.max(np.abs(np.asarray(dev, np.float64) - ref))) / scale


def _result(name, errors, limits):
    ok = all(np.isfinite(errors[q]) and errors[q] <= limits[q] for q in errors)
    return {"name": name, "errors": errors, "limits": dict(limits), "ok": ok}


def format_result(r) -> str:
    parts = [f"{q} {r['errors'][q]:.3e} (limit {r['limits'][q]:.0e})"
             for q in r["errors"]]
    return f"[check] {r['name']}: {'PASS' if r['ok'] else 'FAIL'} — " + \
        ", ".join(parts)


# ------------------------------------------------------------- Burgers fast step

def numpy_abcn_macro_step(cfg, pool_ek_ktt, st, actions):
    """float64 numpy macro-step of the spectral-reward Burgers closure env.

    ABCN sub-steps (Burger.py:482-489): Fn = i k FFT(u^2/2),
    v <- ((1 - C) v - dt/2 (3 Fn - Fn_old) + dt F) / (1 + C), C = nu k^2 dt/2,
    with F the FFT of the action forcing field (actions @ basis,
    Burger.py:437,442); energy spectrum 0.5 |v|^2 / N dx summed per sub-step
    (Burger.py:562); reward = previous minus current mean squared relative
    error of the cumulative-mean spectrum against the DNS
    (burger_environment.py:172-180).  ``st`` holds numpy arrays: u, v
    (complex), fn (complex), nu (B,), sidx, ioutnum, ek_sum, prev_rel_err.
    """
    from marlpde_tpu.envs import burger_env
    B, N = st["u"].shape
    g = cfg.grid_size
    dt = cfg.dt
    dx = cfg.L / N
    basis = np.asarray(burger_env.action_basis(cfg), np.float64)
    forcing = np.fft.fft(actions.reshape(B, -1) @ basis, axis=-1)
    k = 2.0 * np.pi * np.fft.fftfreq(N, dx)
    C = 0.5 * st["nu"][:, None] * k * k * dt
    u, v, fn, ek = st["u"], st["v"], st["fn"], np.zeros((B, N))
    for _ in range(cfg.n_intermediate):
        fn_new = 1j * k * np.fft.fft(0.5 * u * u, axis=-1)
        v = ((1.0 - C) * v - 0.5 * dt * (3.0 * fn_new - fn) + dt * forcing) \
            / (1.0 + C)
        fn = fn_new
        u = np.real(np.fft.ifft(v, axis=-1))
        ek = ek + 0.5 * np.abs(v) ** 2 / N * dx
    ioutnum = st["ioutnum"] + cfg.n_intermediate
    ek_sum = st["ek_sum"] + ek
    sgs = ek_sum[:, 1:g // 2] / (ioutnum + 1.0)[:, None]
    dns = pool_ek_ktt[st["sidx"], ioutnum, 1:g // 2]
    rel_err = np.mean((np.abs(dns - sgs) / dns) ** 2, axis=-1)
    reward = (st["prev_rel_err"] - rel_err) * cfg.reward_factor
    return dict(u=u, v=v, fn=fn, nu=st["nu"], sidx=st["sidx"],
                ioutnum=ioutnum, ek_sum=ek_sum, prev_rel_err=rel_err), reward


def _fast_state_to_numpy(s):
    f64 = lambda a: np.asarray(a, np.float64)
    return dict(u=f64(s.u), v=f64(s.v_re) + 1j * f64(s.v_im),
                fn=f64(s.fn_re) + 1j * f64(s.fn_im), nu=f64(s.nu)[:, 0],
                sidx=np.asarray(s.sidx), ioutnum=np.asarray(s.ioutnum),
                ek_sum=f64(s.ek_sum), prev_rel_err=f64(s.prev_rel_err))


def fast_step_vs_float64(env, B: int, n_macro: int = 5, seed: int = 0,
                         use_pallas: bool = False, interpret: bool = False,
                         action_scale: float = 0.1):
    """Advance the whole-batch fast env (burger_fast.step) ``n_macro``
    macro-steps on the default device with seeded actions, against
    numpy_abcn_macro_step in float64 from the same initial state.  Compares
    u, ek_sum and the reward after every macro-step."""
    from marlpde_tpu.envs import burger_fast
    cfg, pool = env.cfg, env.consts
    keys = jax.random.split(jax.random.key(seed), B)
    st, _ = jax.jit(lambda p, k, c: burger_fast.reset(cfg, p, k, c))(
        pool, keys, jnp.arange(B))
    step = jax.jit(lambda p, s, a: burger_fast.step(
        cfg, p, s, a, use_pallas=use_pallas, interpret=interpret))
    ref = _fast_state_to_numpy(st)
    ek_ktt = np.asarray(pool.ek_ktt, np.float64)
    rng = np.random.default_rng(seed)
    errors = {q: 0.0 for q in BURGERS_LIMITS}
    for _ in range(n_macro):
        a = (action_scale * rng.standard_normal(
            (B, cfg.num_agents, cfg.actions_per_agent))).astype(np.float32)
        st, _obs, rew, _done, _ = step(pool, st, jnp.asarray(a))
        ref, ref_rew = numpy_abcn_macro_step(cfg, ek_ktt, ref,
                                             a.astype(np.float64))
        errors["u"] = max(errors["u"], _worst(st.u, ref["u"]))
        errors["ek_sum"] = max(errors["ek_sum"],
                               _worst(st.ek_sum, ref["ek_sum"]))
        # reward is a difference of relative errors: measure it against the
        # scale of the relative error itself
        scale = max(float(np.max(np.abs(ref["prev_rel_err"]))), 1e-300)
        err_r = float(np.max(np.abs(np.asarray(rew, np.float64)
                                    - ref_rew[:, None]))) / scale
        errors["reward"] = max(errors["reward"], err_r)
    name = (f"fast step {'pallas kernel' if use_pallas else 'plain XLA'} "
            f"vs float64, B={B}, {n_macro} macro-steps x "
            f"{cfg.n_intermediate} sub-steps")
    return _result(name, errors, BURGERS_LIMITS)


# -------------------------------------------------------------------- KS LES

def numpy_etdrk4_step(cfg, rv):
    """float64 ETDRK4 step of the KS half-spectrum (Kassam & Trefethen,
    KS.py:230-267) with coefficients from solvers.ks.etdrk4_coeffs."""
    from marlpde_tpu.solvers import ks
    E, E2, Q, f1, f2, f3, gk = ks.etdrk4_coeffs(cfg)
    N = cfg.N

    def nl(z):
        uz = np.fft.irfft(z, N, axis=-1)
        return gk * np.fft.rfft(uz * uz, axis=-1)

    Nv = nl(rv)
    a = E2 * rv + Q * Nv
    Na = nl(a)
    b = E2 * rv + Q * Na
    Nb = nl(b)
    c = E2 * a + Q * (2.0 * Nb - Nv)
    Nc = nl(c)
    return E * rv + Nv * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3


def ks_les_vs_float64(env, B: int, n_macro: int = 50, seed: int = 0):
    """Uncontrolled KS LES (zero actions) through the vmapped ks_env.step on
    the default device, against numpy_etdrk4_step in float64 from the same
    initial half-spectrum: pointwise over the first KS_POINTWISE_STEPS
    macro-steps, time-mean energy and spectrum over all of them."""
    cfg, pool = env.cfg, env.consts
    lcfg = cfg.les_solver
    keys = jax.random.split(jax.random.key(seed), B)
    st, _ = jax.jit(jax.vmap(lambda k, c: env.reset(pool, k, c),
                             in_axes=(0, 0)))(keys, jnp.arange(B))
    zero = jnp.zeros((B, env.num_agents, env.act_dim), jnp.float32)
    step = jax.jit(jax.vmap(lambda s, a: env.step(pool, s, a)[0]))
    rv = np.asarray(st.solver.rv).astype(np.complex128)
    dev_u, ref_u = [], []
    for _ in range(n_macro):
        st = step(st, zero)
        for _ in range(cfg.n_intermediate):
            rv = numpy_etdrk4_step(lcfg, rv)
        dev_u.append(np.asarray(st.solver.u, np.float64))
        ref_u.append(np.fft.irfft(rv, lcfg.N, axis=-1))
    dev_u, ref_u = np.stack(dev_u), np.stack(ref_u)      # (T, B, N)
    energy = lambda uu: np.mean(0.5 * uu * uu, axis=(0, 2))
    spec = lambda uu: np.mean(np.abs(np.fft.rfft(uu, axis=-1)) ** 2,
                              axis=(0, 1))
    s_ref = spec(ref_u)
    live = s_ref > 1e-6 * s_ref.max()
    errors = {
        "u_first_steps": _worst(dev_u[:KS_POINTWISE_STEPS],
                                ref_u[:KS_POINTWISE_STEPS]),
        "energy": float(np.max(np.abs(energy(dev_u) / energy(ref_u) - 1.0))),
        "spectrum": float(np.max(np.abs(spec(dev_u)[live] / s_ref[live]
                                        - 1.0))),
    }
    name = (f"KS LES N={lcfg.N} uncontrolled vs float64, B={B}, {n_macro} "
            f"macro-steps x {cfg.n_intermediate} ETDRK4 steps")
    return _result(name, errors, KS_LIMITS)


# ------------------------------------------------------------------- timings

def time_call(fn, *args, reps: int = 5):
    """(first-call seconds incl. compile, median seconds of ``reps`` calls)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times))


def time_macro_steps(env, B: int, use_pallas: bool, n_macro: int = 10,
                     reps: int = 5):
    """Median seconds per macro-step of the fast env step (no policy) over a
    jitted scan of ``n_macro`` macro-steps at batch B."""
    from marlpde_tpu.envs import burger_fast
    cfg, pool = env.cfg, env.consts
    keys = jax.random.split(jax.random.key(0), B)
    st, _ = jax.jit(lambda p, k, c: burger_fast.reset(cfg, p, k, c))(
        pool, keys, jnp.arange(B))
    a = 0.1 * jax.random.normal(jax.random.key(1),
                                (B, cfg.num_agents, cfg.actions_per_agent))

    @jax.jit
    def run(p, s):
        def body(s_, _):
            s_, _o, r, _d, _ = burger_fast.step(cfg, p, s_, a,
                                                use_pallas=use_pallas)
            return s_, r.mean()
        return jax.lax.scan(body, s, None, length=n_macro)

    _, med = time_call(run, pool, st, reps=reps)
    return med / n_macro


def time_policy_forward(rl_cfg, rows: int, reps: int = 20):
    """Median seconds of one acting forward (vracer.policy_apply) over
    ``rows`` observations at the config's width."""
    from marlpde_tpu.rl import vracer
    ts = vracer.init_train(rl_cfg, jax.random.key(0))
    obs = jax.random.normal(jax.random.key(1), (rows, rl_cfg.obs_dim))
    fn = jax.jit(lambda t, o: vracer.policy_apply(rl_cfg, t, o))
    _, med = time_call(fn, ts, obs, reps=reps)
    return med


def generation_timer(env, rl_cfg, tc):
    """Build one fused training generation (trainer.build_fused_generation)
    and run it once.  Returns (seconds of that compile + first call, timed)
    where ``timed()`` runs the next generation and returns (seconds, stats),
    so two variants can be timed in turns."""
    from marlpde_tpu.rl import vracer
    from marlpde_tpu.train import trainer
    upd = trainer.updates_per_generation(rl_cfg, tc, env.episode_length)
    gen = trainer.build_fused_generation(env, rl_cfg, tc, upd)
    carry = dict(ts=vracer.init_train(rl_cfg, jax.random.key(tc.seed)),
                 rep=trainer.make_replay(env, rl_cfg),
                 key=jax.random.key(tc.seed + 1), base=0)

    def timed():
        key, k_c, k_u = jax.random.split(carry["key"], 3)
        t0 = time.perf_counter()
        ts, rep, _traj, _final, _m, stats = jax.block_until_ready(
            gen(carry["ts"], carry["rep"], k_c, k_u,
                jnp.asarray(carry["base"]), env.consts))
        dt = time.perf_counter() - t0
        carry.update(ts=ts, rep=rep, key=key, base=carry["base"] + tc.num_envs)
        return dt, jax.device_get(stats)

    first, _ = timed()
    return first, timed


# ------------------------------------------------------------- device mesh

# The same sharded program on the GPUs and on CPU devices in float32: the
# first generation collects with the initial (identical) policy, so its
# return differs only by the GPU's TF32 policy matmuls and summation order;
# after the updates Adam's normalized steps can flip sign on near-zero
# gradient components, so parameters may differ by up to ~2 lr per update.
MESH_RETURN_LIMIT = 1e-2


def mesh_run(env, rl_cfg, devices, envs_per_device: int, updates_per_gen: int,
             n_generations: int = 3, seed: int = 0):
    """parallel/mesh.run_generations over a 1-D mesh of ``devices``."""
    from marlpde_tpu.parallel import mesh as pmesh
    return pmesh.run_generations(
        env, rl_cfg, pmesh.make_mesh(devices), envs_per_device=envs_per_device,
        updates_per_gen=updates_per_gen, n_generations=n_generations,
        seed=seed)


def mesh_invariants(ts, rep, n_devices: int):
    """Distributed-training invariants after a mesh run: updates taken, the
    replicated train state bitwise equal on every device, every replay shard
    filled.  Returns (ok, message)."""
    n_upd = int(jax.device_get(ts.n_updates))
    same = True
    for leaf in jax.tree.leaves(ts):
        shards = getattr(leaf, "addressable_shards", None) or []
        ref = np.asarray(shards[0].data) if shards else None
        same &= len(shards) == n_devices and all(
            np.array_equal(np.asarray(s.data), ref) for s in shards[1:])
    counter = getattr(rep, "cursor", None)
    if counter is None or np.ndim(counter) == 0:
        counter = rep.filled
    filled = [int(np.asarray(s.data).ravel()[0])
              for s in counter.addressable_shards]
    ok = n_upd > 0 and same and len(filled) == n_devices and min(filled) > 0
    msg = (f"[mesh] {n_devices} devices: updates {n_upd}, replicated state "
           f"bitwise equal {same}, replay shards filled {filled}: "
           f"{'PASS' if ok else 'FAIL'}")
    return ok, msg


def mesh_vs_other_devices(env, rl_cfg, devices_a, devices_b,
                          envs_per_device: int, updates_per_gen: int,
                          n_generations: int = 2, seed: int = 0):
    """Run the same sharded program at the same keys on two device sets
    (the GPUs and CPU devices) and compare: first-generation return
    (relative), then parameters against 2 lr per update taken."""
    ts_a, _, h_a = mesh_run(env, rl_cfg, devices_a, envs_per_device,
                            updates_per_gen, n_generations, seed)
    ts_b, _, h_b = mesh_run(env, rl_cfg, devices_b, envs_per_device,
                            updates_per_gen, n_generations, seed)
    r_a, r_b = h_a["mean_return"][0], h_b["mean_return"][0]
    n_upd = int(jax.device_get(ts_a.n_updates))
    same_upd = n_upd == int(jax.device_get(ts_b.n_updates))
    pa = jax.tree.leaves(jax.device_get(ts_a.params))
    pb = jax.tree.leaves(jax.device_get(ts_b.params))
    dp = max(float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y))))
             for x, y in zip(pa, pb))
    errors = {"gen1_return": abs(r_a - r_b) / max(abs(r_b), 1e-30),
              "params": dp if same_upd else np.inf}
    limits = {"gen1_return": MESH_RETURN_LIMIT,
              "params": 2.0 * rl_cfg.lr * max(n_upd, 1)}
    name = (f"mesh {len(devices_a)}x {devices_a[0].platform} vs "
            f"{len(devices_b)}x {devices_b[0].platform}, {n_generations} "
            f"generations, {n_upd} updates")
    return _result(name, errors, limits)
