"""Pallas macro-step kernel validation in interpret mode on the CPU (the
compiled Triton kernel runs in the gpu-marked tests of test_chip_checks.py
and in chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Route every kernel call (also those the registry wires up) through the
    Pallas interpreter: the CPU has no compiled Pallas path."""
    from marlpde_tpu.ops import abcn_pallas
    kernel = abcn_pallas.abcn_macro_step
    monkeypatch.setattr(abcn_pallas, "abcn_macro_step",
                        lambda *a, **kw: kernel(*a, **{**kw, "interpret": True}))


class TestAbcnKernel:
    def _inputs(self, B, N, seed=0):
        rng = np.random.default_rng(seed)
        u = (rng.standard_normal((B, N)) * 0.1).astype(np.float32)
        v = np.fft.fft(u, axis=-1)
        return dict(
            u=jnp.asarray(u),
            v_re=jnp.asarray(v.real.astype(np.float32)),
            v_im=jnp.asarray(v.imag.astype(np.float32)),
            fn_re=jnp.zeros((B, N), jnp.float32),
            fn_im=jnp.zeros((B, N), jnp.float32),
            nu=jnp.full((B, 1), 0.02, jnp.float32),
            af_re=jnp.asarray((rng.standard_normal((B, N)) * 0.01).astype(np.float32)),
            af_im=jnp.asarray((rng.standard_normal((B, N)) * 0.01).astype(np.float32)))

    def test_matches_jnp_reference(self):
        from marlpde_tpu.ops import abcn_pallas
        B, N = 8, 32
        args = self._inputs(B, N)
        kw = dict(n_intermediate=5, dt=1e-3, dx=float(2 * np.pi / N))
        out_k = abcn_pallas.abcn_macro_step(**args, **kw, tile_b=16)
        out_r = abcn_pallas.abcn_macro_step_reference(**args, **kw)
        names = ["u", "u_prev", "v_re", "v_im", "fn_re", "fn_im", "ek"]
        for i, name in enumerate(names):
            np.testing.assert_allclose(np.asarray(out_k[i]), np.asarray(out_r[i]),
                                       atol=2e-6, err_msg=name)

    def test_matches_complex_abcn_solver(self):
        # the real-arithmetic kernel math reproduces the complex ABCN stepper
        from marlpde_tpu.ops import abcn_pallas
        from marlpde_tpu.solvers import burger
        B, N = 4, 32
        L = 2 * np.pi
        args = self._inputs(B, N, seed=3)
        args["af_re"] = jnp.zeros((B, N), jnp.float32)
        args["af_im"] = jnp.zeros((B, N), jnp.float32)
        # the solver seeds fn_old = k1*fft(0.5*u^2) at init (Burger.py:320)
        u_np = np.asarray(args["u"])
        k = np.fft.fftfreq(N, 1.0 / N)
        D = np.fft.fft(0.5 * u_np * u_np, axis=-1)
        args["fn_re"] = jnp.asarray((-k * D.imag).astype(np.float32))
        args["fn_im"] = jnp.asarray((k * D.real).astype(np.float32))
        kw = dict(n_intermediate=4, dt=1e-3, dx=float(L / N))
        out = abcn_pallas.abcn_macro_step(**args, **kw, tile_b=16)
        cfg = burger.BurgerConfig(N=N, L=L, dt=1e-3, nu=0.02)
        st = burger.init(cfg, u0=args["u"])
        for _ in range(4):
            st, _ = burger.step(cfg, st)
        np.testing.assert_allclose(np.asarray(out[0]), np.asarray(st.u), atol=2e-5)

    def test_multiple_tiles(self):
        from marlpde_tpu.ops import abcn_pallas
        B, N = 64, 32
        args = self._inputs(B, N, seed=7)
        kw = dict(n_intermediate=3, dt=1e-3, dx=float(2 * np.pi / N))
        out_tiled = abcn_pallas.abcn_macro_step(**args, **kw, tile_b=16)
        out_whole = abcn_pallas.abcn_macro_step(**args, **kw, tile_b=64)
        np.testing.assert_allclose(np.asarray(out_tiled[0]),
                                   np.asarray(out_whole[0]), atol=1e-6)

    @pytest.mark.parametrize("B,tile_b", [(1, 16), (37, 16), (45, 32)])
    def test_pads_batch_to_tile(self, B, tile_b):
        """B that is not a multiple of the tile (even prime B) is padded in
        the wrapper; every real row matches the reference and the padding
        never reaches the caller."""
        from marlpde_tpu.ops import abcn_pallas
        N = 32
        args = self._inputs(B, N, seed=B)
        kw = dict(n_intermediate=4, dt=1e-3, dx=float(2 * np.pi / N))
        out_k = abcn_pallas.abcn_macro_step(**args, **kw, tile_b=tile_b)
        out_r = abcn_pallas.abcn_macro_step_reference(**args, **kw)
        for a, b in zip(out_k, out_r):
            assert a.shape == (B, N)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-6)

    @pytest.mark.parametrize("tile_b", [8, 24])
    def test_rejects_tiles_triton_cannot_take(self, tile_b):
        from marlpde_tpu.ops import abcn_pallas
        args = self._inputs(16, 32)
        with pytest.raises(ValueError, match="power of two"):
            abcn_pallas.abcn_macro_step(**args, n_intermediate=1, dt=1e-3,
                                        dx=0.2, tile_b=tile_b)


class TestFastEnvParity:
    def _setup(self):
        from marlpde_tpu.envs import burger_env, registry
        cfg = burger_env.BurgerEnvConfig(
            N_dns=64, grid_size=32, num_actions=32, num_agents=4,
            dt=0.01, T=0.5, nu=0.05, episode_length=5, ic_case="turbulence",
            spectral_reward=True, noise=0.0, version=0)
        pool = burger_env.make_dns_pool(cfg, 1, dtype=jnp.float32)
        return cfg, pool

    @pytest.mark.parametrize("use_pallas,version", [(False, 0), (True, 0),
                                                    (False, 1), (True, 1)])
    def test_fast_step_matches_general_env(self, use_pallas, version):
        from marlpde_tpu.envs import burger_env, burger_fast
        cfg, pool = self._setup()
        cfg = dataclasses.replace(cfg, version=version)
        B = 4
        keys = jax.random.split(jax.random.key(0), B)
        counts = jnp.arange(B)

        fstate, fobs = burger_fast.reset(cfg, pool, keys, counts)
        gstate, gobs = jax.vmap(lambda k, c: burger_env.reset(cfg, pool, k, c))(keys, counts)
        np.testing.assert_allclose(np.asarray(fobs), np.asarray(gobs), atol=1e-6)

        rngA = np.random.default_rng(1)
        for i in range(3):
            a = jnp.asarray(rngA.standard_normal(
                (B, cfg.num_agents, cfg.actions_per_agent)).astype(np.float32))
            fstate, fobs, frew, fdone, _ = burger_fast.step(
                cfg, pool, fstate, a, use_pallas=use_pallas)
            gstate, gobs, grew, gdone, _ = jax.vmap(
                lambda s, aa: burger_env.step(cfg, pool, s, aa))(gstate, a)
            np.testing.assert_allclose(np.asarray(frew), np.asarray(grew),
                                       atol=2e-4, err_msg=f"step {i}")
            np.testing.assert_allclose(np.asarray(fstate.u), np.asarray(gstate.solver.u),
                                       atol=2e-4, err_msg=f"step {i}")
            # obs parity covers the u_prev (dudt) feature for version 1
            np.testing.assert_allclose(np.asarray(fobs), np.asarray(gobs),
                                       atol=5e-2, err_msg=f"obs step {i}")


class TestFastRolloutWiring:
    """The whole-batch fast env is the TRAINING rollout backend for qualifying
    configs (VERDICT r1 item 1): registry attaches batch_reset/batch_step and
    collect_episodes rolls out through them instead of the vmapped env."""

    _kw = dict(N_dns=64, grid_size=32, num_actions=32, num_agents=4,
               dt=0.01, T=0.5, nu=0.05, episode_length=5,
               ic_case="turbulence", spectral_reward=True, noise=0.0)

    def test_registry_attaches_fast_backend(self):
        from marlpde_tpu.envs import registry
        env = registry.make_env("burger", **self._kw)
        assert env.batch_step is not None and env.batch_reset is not None
        assert registry.fast_burger_ok(env.cfg)

    def test_registry_fast_off_and_nonqualifying(self):
        from marlpde_tpu.envs import registry
        env = registry.make_env("burger", fast="off", **self._kw)
        assert env.batch_step is None
        for bad in (dict(spectral_reward=False), dict(ssm=True),
                    dict(coupled=True), dict(dforce=False),
                    dict(scheme="fd", state_bound=1e6)):
            env = registry.make_env("burger", **{**self._kw, **bad})
            assert env.batch_step is None, bad

    def test_registry_pallas_refuses_nonqualifying(self):
        """fast='pallas' on a config the fast path does not implement raises
        instead of quietly training on the general env."""
        from marlpde_tpu.envs import registry
        with pytest.raises(ValueError, match="fast_burger_ok"):
            registry.make_env("burger", fast="pallas",
                              **{**self._kw, "spectral_reward": False})

    @pytest.mark.parametrize("fast", ["auto", "pallas"])
    def test_collect_matches_general_env(self, fast):
        from marlpde_tpu.envs import registry, rollout
        from marlpde_tpu.train import trainer
        from marlpde_tpu.rl import vracer
        env_g = registry.make_env("burger", fast="off", **self._kw)
        env_f = registry.make_env("burger", cfg=env_g.cfg, pool=env_g.consts,
                                  fast=fast)
        rl_cfg = trainer.default_rl_config(env_g, width=16)
        ts = vracer.init_train(rl_cfg, jax.random.key(0))
        k = jax.random.key(7)
        tg, fg = rollout.collect_episodes(env_g, rl_cfg, ts, k, 4)
        tf, ff = rollout.collect_episodes(env_f, rl_cfg, ts, k, 4)
        for name in ("obs", "actions", "rewards", "mask"):
            np.testing.assert_allclose(np.asarray(tf[name]),
                                       np.asarray(tg[name]),
                                       atol=5e-4, err_msg=name)
        np.testing.assert_allclose(np.asarray(ff.cum_reward),
                                   np.asarray(fg.cum_reward), atol=2e-3)
        np.testing.assert_array_equal(np.asarray(tf["truncated"]),
                                      np.asarray(tg["truncated"]))

    def test_fused_training_generation_on_fast_backend(self):
        """trainer.build_fused_generation (the bench BENCH_MODE=train program)
        runs end-to-end on the whole-batch backend."""
        from marlpde_tpu.envs import registry
        from marlpde_tpu.train import trainer
        from marlpde_tpu.rl import vracer
        env = registry.make_env("burger", **self._kw)
        assert env.batch_step is not None
        rl_cfg = trainer.default_rl_config(env, width=16,
                                           replay_start_experiences=5,
                                           replay_max_experiences=100)
        tc = trainer.TrainerConfig(num_envs=4, max_updates_per_gen=2)
        upd = trainer.updates_per_generation(rl_cfg, tc, env.episode_length)
        gen_fn = trainer.build_fused_generation(env, rl_cfg, tc, upd)
        ts = vracer.init_train(rl_cfg, jax.random.key(0))
        rep = trainer.make_replay(env, rl_cfg)
        ts, rep, traj, final, metrics, stats = gen_fn(
            ts, rep, jax.random.key(1), jax.random.key(2),
            jnp.asarray(0), env.consts)
        assert int(rep.filled) == 4
        assert np.isfinite(float(stats["mean_return"]))
