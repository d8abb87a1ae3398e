"""The reference comparisons of chip_smoke.py (analysis/chip_checks.py): at
tiny sizes on the CPU, and at the flagship sizes in the gpu-marked tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from marlpde_tpu.analysis import chip_checks as cc

_TINY = dict(N_dns=64, grid_size=32, num_actions=32, num_agents=4, dt=0.01,
             T=0.5, nu=0.05, episode_length=5, ic_case="turbulence",
             spectral_reward=True, noise=0.0)


def _tiny_env(dtype=jnp.float32):
    from marlpde_tpu.envs import registry
    return registry.make_env("burger", dtype=dtype, **_TINY)


def _ks_env(N_dns=1024):
    from marlpde_tpu.envs import registry
    return registry.make_env("ks", N_dns=N_dns, grid_size=32, num_actions=32,
                             episode_length=500, noise=0.0, seed=42, n_dns=2)


def _flagship_env():
    from marlpde_tpu import run
    args = run.build_parser().parse_args(
        ["burger-marl", "--specreward", "--dforce", "--fused", "--ic",
         "turbulence"])
    return run.make_workload(args)[0]


def test_require_gpu_refuses_cpu():
    import chip_smoke
    with pytest.raises(SystemExit, match="needs a GPU backend"):
        chip_smoke.require_gpu(jax)


def test_numpy_macro_step_matches_complex_solver():
    """The float64 oracle reproduces solvers.burger (ABCN) with zero
    actions, sub-step for sub-step, at float64 round-off."""
    from marlpde_tpu.envs import burger_fast
    from marlpde_tpu.solvers import burger
    env = _tiny_env(jnp.float64)
    cfg = env.cfg
    B = 3
    st, _ = burger_fast.reset(cfg, env.consts,
                              jax.random.split(jax.random.key(0), B),
                              jnp.arange(B))
    ref = cc._fast_state_to_numpy(st)
    a = np.zeros((B, cfg.num_agents, cfg.actions_per_agent))
    out, _ = cc.numpy_abcn_macro_step(
        cfg, np.asarray(env.consts.ek_ktt, np.float64), ref, a)
    lcfg = cfg.les_solver
    sol = burger.BurgerState(
        u=st.u, v=jax.lax.complex(st.v_re, st.v_im),
        fn_old=jax.lax.complex(st.fn_re, st.fn_im),
        t=jnp.zeros(B), ioutnum=st.ioutnum, nu=st.nu[:, 0],
        offset=jnp.zeros(B), randfac1=jnp.zeros((B, 4, 1)),
        randfac2=jnp.zeros((B, 4, 1)))
    for _ in range(cfg.n_intermediate):
        sol, _ = burger.step(lcfg, sol, jnp.zeros((B, cfg.grid_size)))
    np.testing.assert_allclose(out["u"], np.asarray(sol.u), atol=1e-12)


@pytest.mark.parametrize("B,use_pallas", [(16, False), (37, True)])
def test_fast_step_vs_float64(B, use_pallas):
    r = cc.fast_step_vs_float64(_tiny_env(), B=B, use_pallas=use_pallas,
                                interpret=use_pallas)
    assert r["ok"], cc.format_result(r)
    assert set(r["errors"]) == set(cc.BURGERS_LIMITS)


def test_fast_step_check_catches_a_wrong_device_step(monkeypatch):
    """The comparison is sensitive: a device macro-step whose time step is
    0.1% off fails it."""
    from marlpde_tpu.ops import abcn_pallas
    step = abcn_pallas.abcn_macro_step_reference
    monkeypatch.setattr(abcn_pallas, "abcn_macro_step_reference",
                        lambda *a, **kw: step(*a, **{**kw,
                                                     "dt": kw["dt"] * 1.001}))
    r = cc.fast_step_vs_float64(_tiny_env(), B=8)
    assert not r["ok"], cc.format_result(r)


def test_ks_les_vs_float64():
    r = cc.ks_les_vs_float64(_ks_env(), B=4, n_macro=50)
    assert r["ok"], cc.format_result(r)


def test_format_result_names_every_limit():
    r = cc._result("x", {"a": 1e-7, "b": 3.0}, {"a": 1e-6, "b": 1.0})
    assert not r["ok"]
    line = cc.format_result(r)
    assert "FAIL" in line and "a 1.000e-07 (limit 1e-06)" in line


def test_mesh_invariants_and_cross_device_comparison():
    """The --devices 4 phase on CPU devices: 4 of the 8 virtual devices
    against the other 4."""
    import __graft_entry__ as graft
    from marlpde_tpu.train import trainer
    env, _ = graft._flagship(small=True)
    rl = trainer.default_rl_config(
        env, width=16, replay_start_experiences=4, replay_max_experiences=800,
        minibatch_mode="experience", mini_batch_size=16)
    devs = jax.devices()
    ts, rep, _ = cc.mesh_run(env, rl, devs[:4], envs_per_device=1,
                             updates_per_gen=2, n_generations=2)
    ok, msg = cc.mesh_invariants(ts, rep, 4)
    assert ok, msg
    r = cc.mesh_vs_other_devices(env, rl, devs[:4], devs[4:8],
                                 envs_per_device=1, updates_per_gen=2)
    assert r["ok"], cc.format_result(r)


@pytest.mark.gpu
@pytest.mark.parametrize("B,use_pallas", [(1024, False), (1024, True),
                                          (4096, True)])
def test_flagship_fast_step_on_gpu(gpu, B, use_pallas):
    r = cc.fast_step_vs_float64(_flagship_env(), B=B, use_pallas=use_pallas)
    assert r["ok"], cc.format_result(r)


@pytest.mark.gpu
def test_ks_les_on_gpu(gpu):
    r = cc.ks_les_vs_float64(_ks_env(), B=64, n_macro=50)
    assert r["ok"], cc.format_result(r)
