"""Policy evaluation sweeps: the burger_testing_environment.py equivalent.

Parity target: burger_testing_environment.py — loop over the whole DNS pool
with the deterministic policy, collect (i) spectral relative-error
trajectories, (ii) learned action fields, (iii) DNS-derived a-priori SGS
terms; dump relError_*.npy / sgsTerms_*.npy / dnsSgsTerms_*.npy (:168-179).
Also the uncontrolled-baseline comparison + makePlot of the single-episode
testing branch (burger_environment.py:241-329).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from marlpde_tpu.analysis import diagnostics, plotting
from marlpde_tpu.core import spectral
from marlpde_tpu.envs import burger_env
from marlpde_tpu.rl import vracer


def _episode_with_policy(cfg, pool, rl_cfg, ts, key, sidx, deterministic=True):
    """One episode on DNS pool row sidx; returns stacked per-macro-step data."""
    state, obs = burger_env.reset(cfg, pool, key, sidx)

    def macro(carry, k):
        st, ob = carry
        if deterministic:
            a = vracer.act_deterministic(rl_cfg, ts, ob)
        else:
            a, _, _ = vracer.act(rl_cfg, ts, ob, k)
        st2, ob2, rew, done, _ = burger_env.step(cfg, pool, st, a)
        count = (st2.solver.ioutnum + 1).astype(st2.solver.u.dtype)
        out = dict(u=st2.solver.u, actions=a, reward=rew,
                   rel_err=st2.prev_rel_err,
                   ektt=st2.ek_sum / count)
        return (st2, ob2), out

    keys = jax.random.split(key, cfg.episode_length)
    (final, _), traj = jax.lax.scan(macro, (state, obs), keys)
    return traj, final


def evaluate_policy(cfg: burger_env.BurgerEnvConfig, pool, rl_cfg, ts,
                    out_dir: str = None, run_tag: int = 0, key=None,
                    make_plots: bool = False, sample_ids=None,
                    file_suffix: str = ""):
    """Sweep the DNS pool with the deterministic policy.

    ``sample_ids`` restricts the sweep to specific pool rows (korali
    e["Solver"]["Testing"]["Sample Ids"], run-vracer-burger.py:203-210);
    default is the whole pool (burger_testing_environment.py behavior).
    ``file_suffix`` tags the .npy dumps (the driver's viscosity sweep writes
    one set per nu).

    Returns dict with relError (P, T), actions (P, T, NA), cumreward (P, na),
    dnsSgsTerms (P, T+1, g); writes the reference's .npy dumps when out_dir
    is given (burger_testing_environment.py:168-179)."""
    key = key if key is not None else jax.random.key(0)
    n_pool = int(pool.nu.shape[0])
    ids = (list(range(n_pool)) if sample_ids is None
           else [int(i) % n_pool for i in sample_ids])
    ep = jax.jit(lambda p, t, k, i: _episode_with_policy(cfg, p, rl_cfg, t, k, i))

    rel_errs, actions, cums = [], [], []
    for i in ids:
        key, k = jax.random.split(key)
        traj, final = ep(pool, ts, k, jnp.asarray(i))
        rel_errs.append(np.asarray(traj["rel_err"]))
        actions.append(np.asarray(traj["actions"]).reshape(cfg.episode_length, -1))
        cums.append(np.asarray(final.cum_reward))

    # DNS a-priori SGS terms (burger_environment.py:244), jitted with the
    # pool as an argument.
    dcfg = cfg.dns_solver
    sgs_fn = jax.jit(lambda p, i: diagnostics.compute_sgs_burger(
        p.uu[i], dcfg.grid.k, dcfg.grid.dx, cfg.dt, p.nu[i], cfg.grid_size))
    dns_sgs = []
    for i in ids:
        terms = sgs_fn(pool, jnp.asarray(i))
        dns_sgs.append(np.asarray(terms["sgs_alt2"]))

    out = dict(relError=np.stack(rel_errs), actions=np.stack(actions),
               cumreward=np.stack(cums), dnsSgsTerms=np.stack(dns_sgs),
               sample_ids=np.asarray(ids))
    if out_dir:
        from marlpde_tpu.utils.async_sink import AsyncSink
        sink = AsyncSink(out_dir)
        sink.write(f"relError_{run_tag}{file_suffix}", out["relError"])
        sink.write(f"sgsTerms_{run_tag}{file_suffix}", out["actions"])
        sink.write(f"dnsSgsTerms_{run_tag}{file_suffix}", out["dnsSgsTerms"])
        sink.flush()
    return out


def compare_with_uncontrolled(cfg: burger_env.BurgerEnvConfig, pool, rl_cfg, ts,
                              key=None, sidx: int = 0, file_prefix: str = None):
    """The testing-mode branch (burger_environment.py:241-329): run the
    controlled episode AND a zero-action baseline; optionally makePlot."""
    key = key if key is not None else jax.random.key(0)
    traj_c, final_c = jax.jit(
        lambda p, t, k: _episode_with_policy(cfg, p, rl_cfg, t, k,
                                             jnp.asarray(sidx)))(pool, ts, key)

    def zero_episode(p, k):
        state, obs = burger_env.reset(cfg, p, k, jnp.asarray(sidx))

        def macro(carry, _):
            st, ob = carry
            a = jnp.zeros((cfg.num_agents, cfg.actions_per_agent), st.solver.u.dtype)
            st2, ob2, rew, done, _ = burger_env.step(cfg, p, st, a)
            return (st2, ob2), dict(u=st2.solver.u, reward=rew,
                                    rel_err=st2.prev_rel_err)

        (final, _), traj = jax.lax.scan(macro, (state, obs), None,
                                        length=cfg.episode_length)
        return traj, final

    traj_b, final_b = jax.jit(zero_episode)(pool, key)

    result = dict(
        controlled_cumreward=np.asarray(final_c.cum_reward),
        baseline_cumreward=np.asarray(final_b.cum_reward),
        controlled_rel_err=np.asarray(traj_c["rel_err"]),
        baseline_rel_err=np.asarray(traj_b["rel_err"]))

    if file_prefix:
        dcfg, lcfg = cfg.dns_solver, cfg.les_solver
        T = cfg.episode_length
        tt = np.arange(1, T + 1) * cfg.dt * cfg.n_intermediate
        dns_ek = jax.jit(lambda p: diagnostics.compute_ek(
            spectral.fft(p.uu[sidx]), dcfg.grid.dx))(pool)
        # DNS a-priori SGS terms — dns.sgsHistory for the 2x2 KDE figure
        # (plotting.py:346-407; terms from Burger.compute_Sgs)
        dns_sgs = jax.jit(lambda p: diagnostics.compute_sgs_burger(
            p.uu[sidx], dcfg.grid.k, dcfg.grid.dx, cfg.dt, p.nu[sidx],
            cfg.grid_size)["sgs"])(pool)
        dns = dict(x=dcfg.grid.x, tt=np.arange(pool.uu.shape[1]) * cfg.dt,
                   uu=np.asarray(pool.uu)[sidx],
                   ek_t=np.asarray(dns_ek["Ek_t"]),
                   ek_ktt=np.asarray(dns_ek["Ek_ktt"]),
                   sgs_history=np.asarray(dns_sgs))
        basis = np.asarray(burger_env.action_basis(cfg))   # (NA, N)

        def mk(tr):
            d = dict(x=lcfg.grid.x, tt=tt, uu=np.asarray(tr["u"]),
                     ek_t=np.asarray(tr["ektt"]).sum(-1)
                     if "ektt" in tr else np.zeros(T),
                     ek_ktt=np.asarray(tr.get(
                         "ektt", np.zeros((T, cfg.grid_size)))))
            if "actions" in tr:
                a = np.asarray(tr["actions"]).reshape(T, -1)
                d["action_fields"] = a
                # applied SGS forcing on the grid — sgs.sgsHistory
                d["sgs_history"] = a @ basis
            return d

        return dict(result, panels=plotting.make_plot(
            dns, mk(traj_b), mk(traj_c), file_prefix, cfg.spectral_reward))
    return result


def ks_testing(cfg, pool, rl_cfg, ts, out_dir: str, run_tag: int = 0,
               key=None, sidx: int = 0):
    """KS testing-mode branch (ks_environment.py:122-183): run the controlled
    episode, store the LES fields npz (x, t, uu, vv, L, N, dt, nu, tEnd —
    :122-127), compute DNS a-priori SGS terms (:129-130 compute_Sgs), run the
    uncontrolled (zero-action) baseline (:132-178) and makePlot the three-way
    comparison (:183).  Returns controlled/baseline cumrewards + rel errors."""
    import os

    from marlpde_tpu.envs import ks_env

    key = key if key is not None else jax.random.key(0)
    lcfg = cfg.les_solver

    def episode(p, t, k, zero):
        state, obs = ks_env.reset(cfg, p, k, jnp.asarray(sidx))

        def macro(carry, kk):
            st, ob = carry
            if zero:
                a = jnp.zeros((cfg.num_agents, cfg.actions_per_agent),
                              st.solver.u.dtype)
            else:
                a = vracer.act_deterministic(rl_cfg, t, ob)
            st2, ob2, rew, done, _ = ks_env.step(cfg, p, st, a)
            count = (st2.solver.ioutnum + 1).astype(st2.solver.u.dtype)
            return (st2, ob2), dict(u=st2.solver.u, actions=a, reward=rew,
                                    rel_err=st2.prev_rel_err,
                                    ektt=st2.ek_sum / count)

        keys = jax.random.split(k, cfg.episode_length)
        (final, _), traj = jax.lax.scan(macro, (state, obs), keys)
        return traj, final

    traj_c, final_c = jax.jit(lambda p, t, k: episode(p, t, k, False))(pool, ts, key)
    traj_b, final_b = jax.jit(lambda p, t, k: episode(p, t, k, True))(pool, ts, key)

    os.makedirs(out_dir, exist_ok=True)
    tt = np.arange(1, cfg.episode_length + 1) * cfg.dt * cfg.n_intermediate
    uu_c = np.asarray(traj_c["u"])
    vv_c = np.fft.fft(uu_c, axis=-1)
    # the reference's controlled-LES dump (ks_environment.py:125-127)
    np.savez(os.path.join(out_dir, f"sgs_{run_tag}.npz"),
             x=np.asarray(lcfg.grid.x), t=tt, uu=uu_c, vv=vv_c, L=cfg.L,
             N=cfg.grid_size, dt=cfg.dt, nu=1.0, tEnd=cfg.t_sim)

    # DNS a-priori SGS terms (ks_environment.py:129-130 dns.compute_Sgs)
    dcfg = cfg.dns_solver
    dns_uu = np.asarray(pool.uu)[sidx]
    sgs_terms = jax.jit(lambda p: diagnostics.compute_sgs_ks(
        p.uu[sidx], dcfg.grid.k, dcfg.grid.dx, cfg.grid_size))(pool)
    np.savez(os.path.join(out_dir, f"dnsSgs_{run_tag}.npz"),
             sgs=np.asarray(sgs_terms))

    dns_ek = jax.jit(lambda p: diagnostics.compute_ek(
        spectral.fft(p.uu[sidx]), dcfg.grid.dx))(pool)
    dns = dict(x=dcfg.grid.x, tt=np.arange(dns_uu.shape[0]) * cfg.dt,
               uu=dns_uu, ek_t=np.asarray(dns_ek["Ek_t"]),
               ek_ktt=np.asarray(dns_ek["Ek_ktt"]),
               sgs_history=np.asarray(sgs_terms))
    basis = np.asarray(ks_env.action_basis(cfg))           # (NA, g)

    def mk(tr, with_sgs=False):
        d = dict(x=lcfg.grid.x, tt=tt, uu=np.asarray(tr["u"]),
                 ek_t=np.asarray(tr["ektt"]).sum(-1),
                 ek_ktt=np.asarray(tr["ektt"]),
                 action_fields=np.asarray(tr["actions"]).reshape(len(tt), -1))
        if with_sgs:
            d["sgs_history"] = d["action_fields"] @ basis
        return d

    plotting.make_plot(dns, mk(traj_b), mk(traj_c, with_sgs=True),
                       os.path.join(out_dir, f"ks_{run_tag}"), spectral=True)
    return dict(controlled_cumreward=np.asarray(final_c.cum_reward),
                baseline_cumreward=np.asarray(final_b.cum_reward),
                controlled_rel_err=np.asarray(traj_c["rel_err"]),
                baseline_rel_err=np.asarray(traj_b["rel_err"]))


def simple_env_testing(env, rl_cfg, ts, out_dir: str, key=None):
    """Testing-mode plots for the diffusion/advection/laplace families
    (diffusion_environment_simple.py:76-81: plotEvolution, plotActionField,
    plotActionDistribution, plotDiffusionField).  Runs ONE deterministic
    episode, recording the solved field, the analytical solution (where the
    family defines one), and the expanded action fields; writes
    evolution/actionfield/actiondist/field pngs into out_dir."""
    import os

    from marlpde_tpu.solvers import advection as adv_mod
    from marlpde_tpu.solvers import diffusion as diff_mod

    key = key if key is not None else jax.random.key(0)
    cfg = env.cfg
    name = env.name

    def truth_of(st):
        if name.startswith("diffusion"):
            return diff_mod.analytical_sinus(st.solver, cfg.solver)
        if name.startswith("advection"):
            return adv_mod.analytical_sinus(st.solver, cfg.solver)
        return None

    def episode(consts, t, k, zero=False):
        state, obs = env.reset(consts, k, jnp.asarray(0))

        def macro(carry, _):
            st, ob = carry
            if zero:
                a = jnp.zeros((env.num_agents, env.act_dim),
                              st.solver.u.dtype)
            else:
                a = vracer.act_deterministic(rl_cfg, t, ob)
            st2, ob2, rew, done, _ = env.step(consts, st, a)
            out = dict(u=st2.solver.u, actions=a, reward=rew, done=done)
            tr = truth_of(st2)
            if tr is not None:
                out["truth"] = tr
            return (st2, ob2), out

        (final, _), traj = jax.lax.scan(macro, (state, obs), None,
                                        length=cfg.episode_length)
        return traj, final

    traj, final = jax.jit(lambda c, t, k: episode(c, t, k))(env.consts, ts, key)

    os.makedirs(out_dir, exist_ok=True)
    x = np.asarray(cfg.solver.grid.x)
    uu = np.asarray(traj["u"])
    tt = np.arange(1, len(uu) + 1) * cfg.solver.dt
    sol = np.asarray(traj["truth"]) if "truth" in traj else None
    # actions -> fields on the grid (uniform per-agent blocks)
    a = np.asarray(traj["actions"]).reshape(len(uu), -1)
    afield = np.repeat(a, max(1, len(x) // a.shape[1]), axis=1)[:, : len(x)]

    plotting.plot_evolution_panels(x, tt, uu, sol,
                                   os.path.join(out_dir, "evolution.png"))
    plotting.plot_action_contour(x, tt, afield,
                                 os.path.join(out_dir, "actionfield.png"))
    plotting.plot_action_distribution(a, os.path.join(out_dir, "actiondist.png"))
    plotting.plot_field_contour(x, tt, uu, os.path.join(out_dir, "field.png"))

    # the older inline-plot variant's 3x6 truth/uncontrolled/controlled panel
    # (advection_environment.py:121-223 — the same makePlot family: field
    # contours, error traces, end spectra, action trajectories)
    if sol is not None:
        traj_b, _ = jax.jit(
            lambda c, t, k: episode(c, t, k, zero=True))(env.consts, ts, key)
        ek = lambda f: np.asarray(jax.jit(lambda u_: diagnostics.compute_ek(
            spectral.fft(u_), cfg.solver.grid.dx)["Ek_ktt"])(f))
        mkd = lambda f, act=None: dict(
            x=x, tt=tt, uu=np.asarray(f), ek_ktt=ek(jnp.asarray(np.asarray(f))),
            **({} if act is None else
               dict(action_fields=np.asarray(act).reshape(len(uu), -1))))
        plotting.make_plot(mkd(sol), mkd(traj_b["u"], traj_b["actions"]),
                           mkd(traj["u"], traj["actions"]),
                           os.path.join(out_dir, "compare"), spectral=False)

    # the reference's learned-policy convergence artifact
    # (plotting_diffusion.py:60-78 plotConvergence -> error_{N}.json, the only
    # checked-in learned-RL results in the reference repo,
    # diffusion_errors/error_{8,16,32,128}.json): mse/linf/mass curves of the
    # deterministic policy vs the analytical solution, plus how long it
    # survived the early-stop rule.
    if sol is not None:
        survived = int(np.asarray(traj["done"]).argmax()) + 1 \
            if bool(np.asarray(traj["done"]).any()) else len(uu)
        curves = diagnostics.error_curves(uu[:survived], sol[:survived],
                                          tt[:survived])
        curves["survived_steps"] = survived
        curves["episode_length"] = int(cfg.episode_length)
        diagnostics.write_error_json(
            os.path.join(out_dir, f"error_rl_{len(x)}.json"), curves)
    return dict(cumreward=np.asarray(final.cum_reward), uu=uu, solution=sol)


def laplace_testing(env, rl_cfg, ts, out_dir: str, key=None):
    """Laplace testing plots (plotting_laplace.py:13-90): evolution panels
    with the FD laplacian ("gradient") dashed, the 3 stencil-channel action
    contours, the gradient-field contour (hessian.pdf), and the per-channel
    action distribution."""
    import os

    key = key if key is not None else jax.random.key(0)
    cfg = env.cfg

    def episode(consts, t, k):
        state, obs = env.reset(consts, k, jnp.asarray(0))

        def macro(carry, _):
            st, ob = carry
            a = vracer.act_deterministic(rl_cfg, t, ob)
            st2, ob2, rew, done, _ = env.step(consts, st, a)
            return (st2, ob2), dict(u=st2.solver.u, actions=a, reward=rew)

        (final, _), traj = jax.lax.scan(macro, (state, obs), None,
                                        length=cfg.episode_length)
        return traj, final

    traj, final = jax.jit(lambda c, t, k: episode(c, t, k))(env.consts, ts, key)
    os.makedirs(out_dir, exist_ok=True)
    x = np.asarray(cfg.solver.grid.x)
    dx = float(cfg.solver.grid.dx)
    uu = np.asarray(traj["u"])                      # (T, N)
    tt = np.arange(1, len(uu) + 1) * cfg.solver.dt
    # the reference's gradientHistory: centered-FD laplacian of u
    grad = (np.roll(uu, -1, 1) - 2 * uu + np.roll(uu, 1, 1)) / dx**2
    a = np.asarray(traj["actions"])                 # (T, na, 3)

    plt = plotting._plt()
    # evolution panels: u solid, laplacian dashed (plotting_laplace.py:13-32)
    fig, axs = plt.subplots(2, 3, sharex=True)
    for i in range(6):
        tidx = min(int(i * len(uu) / 6), len(uu) - 1)
        ax = axs[i // 3, i % 3]
        ax.plot(x, uu[tidx], "-", color="royalblue")
        ax.plot(x, grad[tidx], "--", color="royalblue", alpha=0.8)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "evolution.png"))
    plt.close(fig)

    # 3 stencil-channel action contours (plotting_laplace.py:34-56)
    xa = x[1:]                                     # agents act on rows 1..N-1
    fig, axs = plt.subplots(1, 3, sharex=True, sharey=True, figsize=(12, 4))
    for c in range(3):
        cf = axs[c].contourf(xa, tt, a[:, :, c])
    fig.colorbar(cf)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "actions.png"))
    plt.close(fig)

    # gradient-field contour — "hessian.pdf" (plotting_laplace.py:58-72)
    fig, ax = plt.subplots(figsize=(8, 8))
    cf = ax.contourf(x, tt, grad, levels=50)
    fig.colorbar(cf)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "hessian.png"))
    plt.close(fig)

    # per-channel action distribution (plotting_laplace.py:74-90)
    plotting.plot_action_distribution(a, os.path.join(out_dir, "actiondist.png"))
    # field contour for completeness with the simple-env set
    plotting.plot_field_contour(x, tt, uu, os.path.join(out_dir, "field.png"))
    return dict(cumreward=np.asarray(final.cum_reward), uu=uu, gradient=grad)
