"""RL-layer tests: distributions, V-trace, replay, normalizers, and a
learning smoke test on the diffusion-simple workload (the reference's minimum
end-to-end slice, SURVEY.md §7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from marlpde_tpu.envs import registry
from marlpde_tpu.rl import distributions as D
from marlpde_tpu.rl import replay, running_stats, vracer
from marlpde_tpu.train import trainer


class TestClippedNormal:
    def test_interior_log_prob_matches_scipy(self, rng):
        a = rng.uniform(-4, 4, 32)
        mu = rng.standard_normal(32)
        sigma = rng.uniform(0.5, 2.0, 32)
        got = np.asarray(D.log_prob(jnp.asarray(a), jnp.asarray(mu),
                                    jnp.asarray(sigma), -5.0, 5.0))
        want = stats.norm.logpdf(a, mu, sigma)
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_boundary_masses(self):
        # at the bounds the density is the clipped tail mass
        got_lo = float(D.log_prob(jnp.asarray(-5.0), jnp.asarray(0.0),
                                  jnp.asarray(2.0), -5.0, 5.0))
        np.testing.assert_allclose(got_lo, stats.norm.logcdf(-2.5), rtol=1e-10)
        got_hi = float(D.log_prob(jnp.asarray(5.0), jnp.asarray(1.0),
                                  jnp.asarray(2.0), -5.0, 5.0))
        np.testing.assert_allclose(got_hi, stats.norm.logsf(2.0), rtol=1e-10)

    def test_samples_respect_bounds_and_distribution(self):
        key = jax.random.key(0)
        s = D.sample(key, jnp.zeros(20000), jnp.full(20000, 3.0), -2.0, 2.0)
        s = np.asarray(s)
        assert s.min() >= -2.0 and s.max() <= 2.0
        # clipped mass at bounds ~ Phi(-2/3) each
        frac_lo = (s == -2.0).mean()
        assert abs(frac_lo - stats.norm.cdf(-2 / 3)) < 0.02

    def test_kl_normal_zero_for_identical(self):
        mu = jnp.asarray([[0.5, -1.0]])
        sig = jnp.asarray([[1.0, 2.0]])
        assert float(D.kl_normal(mu, sig, mu, sig)[0]) == pytest.approx(0.0)

    def test_kl_normal_matches_formula(self):
        got = float(D.kl_normal(jnp.asarray([0.0]), jnp.asarray([1.0]),
                                jnp.asarray([1.0]), jnp.asarray([2.0])))
        want = np.log(2.0) + (1.0 + 1.0) / 8.0 - 0.5
        np.testing.assert_allclose(got, want, rtol=1e-7)


class TestVtrace:
    def test_on_policy_reduces_to_discounted_returns(self, rng):
        T, gamma = 6, 0.9
        r = rng.standard_normal(T)
        V = rng.standard_normal(T)
        mask = np.ones(T)
        vtg, adv = vracer._vtrace(jnp.asarray(V)[None], jnp.asarray(r)[None],
                                  jnp.ones((1, T)), jnp.asarray(mask)[None], gamma)
        want = np.zeros(T)
        acc = 0.0
        for t in reversed(range(T)):
            acc = r[t] + gamma * acc
            want[t] = acc
        np.testing.assert_allclose(np.asarray(vtg)[0], want, rtol=1e-6)
        # advantage = r + gamma*vtg_{t+1} - V = vtg_t - V_t on-policy
        np.testing.assert_allclose(np.asarray(adv)[0], want - V, rtol=1e-5, atol=1e-6)

    def test_rho_zero_gives_no_correction(self, rng):
        T = 5
        V = rng.standard_normal(T)
        r = rng.standard_normal(T)
        vtg, _ = vracer._vtrace(jnp.asarray(V)[None], jnp.asarray(r)[None],
                                jnp.zeros((1, T)), jnp.ones((1, T)), 1.0)
        np.testing.assert_allclose(np.asarray(vtg)[0], V, rtol=1e-6)

    def test_mask_stops_bootstrap(self, rng):
        # an episode that ends at t=2 must not bootstrap beyond it
        T = 5
        V = np.ones(T) * 10.0
        r = np.ones(T)
        mask = np.array([1.0, 1.0, 1.0, 0.0, 0.0])
        vtg, _ = vracer._vtrace(jnp.asarray(V)[None], jnp.asarray(r)[None],
                                jnp.ones((1, T)), jnp.asarray(mask)[None], 1.0)
        np.testing.assert_allclose(np.asarray(vtg)[0][:3], [3.0, 2.0, 1.0], rtol=1e-6)


class TestTruncatedBootstrap:
    """Truncated-vs-Terminal episode ends (burger_environment.py:198-204):
    blowup-truncated episodes bootstrap V-trace tails from V(s_T);
    normal ends do not."""

    def test_vtrace_bootstraps_at_last_valid_step(self, rng):
        T, gamma, b = 5, 0.9, 2.5
        r = rng.standard_normal(T)
        V = rng.standard_normal(T)
        mask = np.array([1.0, 1.0, 1.0, 0.0, 0.0])     # episode ends at t=2
        vtg, adv = vracer._vtrace(
            jnp.asarray(V)[None], jnp.asarray(r)[None], jnp.ones((1, T)),
            jnp.asarray(mask)[None], gamma, bootstrap=jnp.asarray([b]))
        # on-policy: vtg = discounted return with V(s_T)=b beyond the end
        want = np.zeros(T)
        acc = b
        for t in reversed(range(3)):
            acc = r[t] + gamma * acc
            want[t] = acc
        np.testing.assert_allclose(np.asarray(vtg)[0][:3], want[:3], rtol=1e-5)
        np.testing.assert_allclose(np.asarray(adv)[0][:3], want[:3] - V[:3],
                                   rtol=1e-4, atol=1e-6)

    def test_zero_bootstrap_matches_no_bootstrap(self, rng):
        T = 4
        V = rng.standard_normal(T)
        r = rng.standard_normal(T)
        mask = np.array([1.0, 1.0, 0.0, 0.0])
        a = vracer._vtrace(jnp.asarray(V)[None], jnp.asarray(r)[None],
                           jnp.ones((1, T)), jnp.asarray(mask)[None], 1.0)
        z = vracer._vtrace(jnp.asarray(V)[None], jnp.asarray(r)[None],
                           jnp.ones((1, T)), jnp.asarray(mask)[None], 1.0,
                           bootstrap=jnp.zeros((1,)))
        for x, y in zip(a, z):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-6)

    def _mk_batch(self, truncated, final_obs_val=0.7):
        K, T, na, od, ad = 1, 3, 1, 2, 1
        return dict(obs=jnp.zeros((K, T, na, od)),
                    actions=jnp.full((K, T, na, ad), 0.1),
                    mu=jnp.zeros((K, T, na, ad)),
                    sigma=jnp.ones((K, T, na, ad)),
                    rewards=jnp.ones((K, T, na)),
                    mask=jnp.asarray([[1.0, 1.0, 0.0]]),
                    final_obs=jnp.full((K, na, od), final_obs_val),
                    truncated=jnp.asarray([truncated]))

    def test_loss_uses_bootstrap_only_when_truncated(self):
        cfg = vracer.VracerConfig(obs_dim=2, act_dim=1, episode_length=3,
                                  state_rescaling=False,
                                  reward_rescaling=False)
        ts = vracer.init_train(cfg, jax.random.key(1))
        _, m_term = vracer._loss(cfg, ts.params, ts, self._mk_batch(False), 4.0)
        _, m_trunc = vracer._loss(cfg, ts.params, ts, self._mk_batch(True), 4.0)
        # the bootstrap shifts the value targets, hence the value loss
        assert float(m_term["v_loss"]) != float(m_trunc["v_loss"])
        # truncated with a zero-value final obs == terminal IF V(final)==0;
        # here just check both are finite
        assert np.isfinite(float(m_trunc["loss"]))

    def test_loss_finite_with_nan_final_obs(self):
        """Pre-blowup final observations can be NaN/inf (burger env freezes
        the post-blowup field); the learner must sanitize them."""
        cfg = vracer.VracerConfig(obs_dim=2, act_dim=1, episode_length=3,
                                  state_rescaling=False,
                                  reward_rescaling=False)
        ts = vracer.init_train(cfg, jax.random.key(1))
        batch = self._mk_batch(True, final_obs_val=np.nan)
        loss, m = vracer._loss(cfg, ts.params, ts, batch, 4.0)
        assert np.isfinite(float(loss))
        g = jax.grad(lambda p: vracer._loss(cfg, p, ts, batch, 4.0)[0])(ts.params)
        assert all(np.all(np.isfinite(np.asarray(l))) for l in jax.tree.leaves(g))

    def test_collect_tags_blowup_episodes(self):
        """A blowup-prone Burgers config must produce truncated=True episodes
        whose final_obs round-trips through replay."""
        from marlpde_tpu.envs import rollout
        env = registry.make_env(
            "burger", N_dns=64, grid_size=16, num_actions=16, num_agents=4,
            dt=0.01, T=1.0, nu=0.02, episode_length=20, ic_case="turbulence",
            spectral_reward=True, noise=0.0, dforce=False)
        rl_cfg = trainer.default_rl_config(env, width=16, init_noise=5.0)
        ts = vracer.init_train(rl_cfg, jax.random.key(0))
        traj, final = rollout.collect_episodes(env, rl_cfg, ts,
                                               jax.random.key(2), 6)
        assert traj["truncated"].shape == (6,)
        assert traj["final_obs"].shape == (6, 4, env.obs_dim)
        # dforce=False with sigma=5 exploration blows up reliably
        assert bool(np.asarray(traj["truncated"]).any())
        # truncated episodes end early: mask sum < T
        tr = np.asarray(traj["truncated"])
        msum = np.asarray(traj["mask"]).sum(1)
        assert (msum[tr] < env.episode_length).all()
        rep = replay.init(8, env.episode_length, 4, env.obs_dim, env.act_dim)
        rep = replay.add_episodes(rep, traj)
        assert bool(np.asarray(rep.truncated).any())


class TestReplay:
    def test_add_sample_roundtrip(self, rng):
        rep = replay.init(capacity=4, T=3, na=2, obs_dim=5, act_dim=2)
        batch = dict(
            obs=jnp.asarray(rng.standard_normal((2, 3, 2, 5)), jnp.float32),
            actions=jnp.asarray(rng.standard_normal((2, 3, 2, 2)), jnp.float32),
            mu=jnp.zeros((2, 3, 2, 2)), sigma=jnp.ones((2, 3, 2, 2)),
            rewards=jnp.ones((2, 3, 2)), mask=jnp.ones((2, 3)),
            final_obs=jnp.zeros((2, 2, 5)),
            truncated=jnp.asarray([False, True]))
        rep = replay.add_episodes(rep, batch)
        assert int(rep.filled) == 2 and int(rep.cursor) == 2
        out = replay.sample_episodes(rep, jax.random.key(0), 8)
        assert out["obs"].shape == (8, 3, 2, 5)
        assert out["final_obs"].shape == (8, 2, 5)
        assert out["truncated"].shape == (8,)
        assert int(replay.num_experiences(rep)) == 6

    def test_ring_overwrite(self):
        rep = replay.init(capacity=3, T=2, na=1, obs_dim=1, act_dim=1)
        for i in range(5):
            batch = dict(obs=jnp.full((1, 2, 1, 1), float(i)),
                         actions=jnp.zeros((1, 2, 1, 1)),
                         mu=jnp.zeros((1, 2, 1, 1)), sigma=jnp.ones((1, 2, 1, 1)),
                         rewards=jnp.zeros((1, 2, 1)), mask=jnp.ones((1, 2)),
                         final_obs=jnp.zeros((1, 1, 1)),
                         truncated=jnp.zeros((1,), bool))
            rep = replay.add_episodes(rep, batch)
        assert int(rep.filled) == 3
        vals = sorted(float(rep.obs[i, 0, 0, 0]) for i in range(3))
        assert vals == [2.0, 3.0, 4.0]   # oldest (0,1) overwritten


class TestMultiAgentCorrelation:
    def test_joint_rho_is_product_over_agents(self):
        """korali Multi Agent Correlation (run-vracer-burger-marl.py:113):
        the importance weight becomes the product over agents.  With two
        identical agents and one (K=1, T=1) experience, mean_rho under MAC
        must equal mean_rho**2 of the uncorrelated case."""
        kw = dict(obs_dim=1, act_dim=1, num_agents=2, episode_length=1,
                  state_rescaling=False, reward_rescaling=False,
                  action_low=-5.0, action_high=5.0)
        cfg_ind = vracer.VracerConfig(**kw)
        cfg_mac = vracer.VracerConfig(multi_agent_correlation=True, **kw)
        ts = vracer.init_train(cfg_ind, jax.random.key(0))
        batch = dict(obs=jnp.zeros((1, 1, 2, 1)),
                     actions=jnp.full((1, 1, 2, 1), 0.3),
                     mu=jnp.full((1, 1, 2, 1), 0.7),
                     sigma=jnp.full((1, 1, 2, 1), 0.9),
                     rewards=jnp.ones((1, 1, 2)), mask=jnp.ones((1, 1)))
        _, m_ind = vracer._loss(cfg_ind, ts.params, ts, batch, cutoff=1e9)
        _, m_mac = vracer._loss(cfg_mac, ts.params, ts, batch, cutoff=1e9)
        np.testing.assert_allclose(float(m_mac["mean_rho"]),
                                   float(m_ind["mean_rho"]) ** 2, rtol=1e-5)

    def test_single_agent_unchanged(self):
        kw = dict(obs_dim=1, act_dim=1, num_agents=1, episode_length=1,
                  state_rescaling=False, reward_rescaling=False)
        ts = vracer.init_train(vracer.VracerConfig(**kw), jax.random.key(0))
        batch = dict(obs=jnp.zeros((1, 1, 1, 1)),
                     actions=jnp.full((1, 1, 1, 1), 0.3),
                     mu=jnp.full((1, 1, 1, 1), 0.7),
                     sigma=jnp.full((1, 1, 1, 1), 0.9),
                     rewards=jnp.ones((1, 1, 1)), mask=jnp.ones((1, 1)))
        for field in ("loss", "mean_rho"):
            a = vracer._loss(vracer.VracerConfig(**kw), ts.params, ts,
                             batch, cutoff=4.0)[1][field]
            b = vracer._loss(
                vracer.VracerConfig(multi_agent_correlation=True, **kw),
                ts.params, ts, batch, cutoff=4.0)[1][field]
            np.testing.assert_allclose(float(a), float(b), rtol=1e-7)


class TestFlatExperienceReplay:
    """korali's uniform-experience minibatch machinery on the flat experience
    ring (replay_flat): compaction, uniform sampling, second-moment reward
    rescaling, whole-episode retrace refresh, replay-wide off-policy
    fraction."""

    T = 5

    def _batch(self, rng, fill=3, T=5, na=1, od=3, ad=1):
        return dict(
            obs=jnp.asarray(rng.standard_normal((fill, T, na, od)), jnp.float32),
            actions=jnp.asarray(rng.standard_normal((fill, T, na, ad)) * 0.1,
                                jnp.float32),
            mu=jnp.zeros((fill, T, na, ad)), sigma=jnp.ones((fill, T, na, ad)),
            rewards=jnp.asarray(rng.standard_normal((fill, T, na)), jnp.float32),
            mask=jnp.asarray(np.stack([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0],
                                       [1, 1, 1, 0, 0]][:fill]), jnp.float32),
            final_obs=jnp.asarray(rng.standard_normal((fill, na, od)),
                                  jnp.float32),
            truncated=jnp.asarray([False, True, False][:fill]))

    def _mk(self, rng, E=32, fill=3, **kw):
        from marlpde_tpu.rl import replay_flat
        batch = self._batch(rng, fill=fill, **kw)
        rep = replay_flat.init_flat(E, E, batch["obs"].shape[2],
                                    batch["obs"].shape[3],
                                    batch["actions"].shape[3])
        sv = jnp.zeros(batch["rewards"].shape)
        vtg = jnp.asarray(rng.standard_normal(batch["rewards"].shape),
                          jnp.float32)
        boot = jnp.asarray(rng.standard_normal(batch["final_obs"].shape[:2]),
                           jnp.float32) * batch["truncated"][:, None]
        return replay_flat.add_episodes(rep, batch, sv, vtg, boot), batch, vtg, boot

    def test_add_compacts_live_steps(self, rng):
        from marlpde_tpu.rl import replay_flat
        rep, batch, vtg, _ = self._mk(rng)
        # masks 5+2+3 -> 10 live experiences packed at slots 0..9
        assert int(rep.cursor) == 10 and int(rep.n_episodes) == 3
        obs = np.asarray(batch["obs"])
        want = np.concatenate([obs[0, :5], obs[1, :2], obs[2, :3]])
        np.testing.assert_array_equal(np.asarray(rep.obs[:10]), want)
        # episode bounds as global ids
        np.testing.assert_array_equal(np.asarray(rep.ep_first[:10]),
                                      [0] * 5 + [5] * 2 + [7] * 3)
        np.testing.assert_array_equal(np.asarray(rep.ep_last[:10]),
                                      [4] * 5 + [6] * 2 + [9] * 3)
        # fresh experiences are on-policy
        assert not bool(np.asarray(rep.off[:10]).any())
        np.testing.assert_array_equal(np.asarray(rep.rho[:10]), 1.0)
        # episode ring holds truncation flag + bootstrap
        np.testing.assert_array_equal(np.asarray(rep.truncated_ep[:3]),
                                      [False, True, False])

    def test_sampler_uniform_over_live(self, rng):
        from marlpde_tpu.rl import replay_flat
        rep, _, _, _ = self._mk(rng)
        g = np.asarray(replay_flat.sample_ids(rep, jax.random.key(0), 4000))
        assert g.min() >= 0 and g.max() <= 9
        frac = np.bincount(g, minlength=10) / 4000
        assert abs(frac - 0.1).max() < 0.03

    def test_reward_scale_is_second_moment(self, rng):
        """korali rescales by sqrt(mean r^2) over the replay — a constant
        reward maps to ~1.  A variance-based std would blow a near-constant
        (bonus-dominated, diffusion_environment_simple.py:32-40) reward up
        by orders of magnitude; this pins the korali behavior."""
        from marlpde_tpu.rl import replay_flat
        rep, batch, _, _ = self._mk(rng)
        rep = rep.replace(rewards=jnp.full_like(rep.rewards, 5e-4))
        s = float(replay_flat.reward_scale(rep))
        np.testing.assert_allclose(s, 5e-4, rtol=1e-3)
        # and the floor keeps -inf blowup rewards out of the statistic
        rep2 = rep.replace(rewards=rep.rewards.at[0, 0].set(-jnp.inf))
        s2 = float(replay_flat.reward_scale(rep2, reward_floor=-1e4))
        assert np.isfinite(s2)

    def test_ring_eviction_fifo(self, rng):
        from marlpde_tpu.rl import replay_flat
        rep, batch, _, _ = self._mk(rng, E=8)   # 10 live into capacity 8
        assert int(rep.cursor) == 10 and int(rep.live) == 8
        # oldest two experiences (global 0,1) overwritten by global 8,9
        obs = np.asarray(batch["obs"])
        np.testing.assert_array_equal(np.asarray(rep.obs[0]), obs[2, 1])
        np.testing.assert_array_equal(np.asarray(rep.obs[2]), obs[0, 2])

    def test_overfull_insert_keeps_newest_rows(self, rng):
        """An insert larger than the ring writes only its newest E rows, so
        every buffer of a slot holds the same experience (a scatter with
        duplicate slots would leave the winner unspecified on the GPU)."""
        from marlpde_tpu.rl import replay_flat
        rep, batch, vtg, _ = self._mk(rng, E=4)   # 10 live into capacity 4
        assert int(rep.cursor) == 10 and int(rep.live) == 4
        obs = np.asarray(batch["obs"])
        live = np.concatenate([obs[0, :5], obs[1, :2], obs[2, :3]])
        for g in range(6, 10):                    # global ids 6..9 survive
            np.testing.assert_array_equal(np.asarray(rep.obs[g % 4]), live[g])
        # the episode bounds stored beside each row belong to that row
        np.testing.assert_array_equal(np.asarray(rep.ep_last)[[6 % 4, 7 % 4]],
                                      [6, 9])
        vt = np.concatenate([np.asarray(vtg)[0, :5], np.asarray(vtg)[1, :2],
                             np.asarray(vtg)[2, :3]])
        np.testing.assert_array_equal(
            np.asarray(rep.vtg)[[g % 4 for g in range(6, 10)]], vt[6:10])

    def test_flat_insert_retrace_matches_vtrace(self, rng):
        """Insert-time retrace values (rho=1) must equal the episode-mode
        _vtrace targets — the two computations share the same math."""
        cfg = vracer.VracerConfig(obs_dim=3, act_dim=1, episode_length=5,
                                  gamma=0.9, state_rescaling=False,
                                  reward_rescaling=False)
        ts = vracer.init_train(cfg, jax.random.key(0))
        from marlpde_tpu.rl import replay_flat
        batch = self._batch(rng, fill=2)
        rep = replay_flat.init_flat(64, 64, 1, 3, 1)
        rep = vracer.flat_insert(cfg, ts, rep, batch)
        V, _, _ = vracer.policy_apply(cfg, ts, batch["obs"])
        boot = np.asarray(vracer._sanitized_final_V(
            cfg, ts.params, ts, batch["final_obs"]))
        r = np.asarray(batch["rewards"])
        Vn = np.asarray(V)
        # terminal episode 0 (len 5): vtg_4 = V_4 + (r_4 - V_4) = r_4
        np.testing.assert_allclose(float(rep.vtg[4, 0]), r[0, 4, 0], rtol=1e-5)
        np.testing.assert_allclose(
            float(rep.vtg[3, 0]), r[0, 3, 0] + 0.9 * r[0, 4, 0], rtol=1e-5)
        # truncated episode 1 (len 2): tail bootstraps from V(final_obs)
        want_last = r[1, 1, 0] + 0.9 * boot[1, 0]
        np.testing.assert_allclose(float(rep.vtg[6, 0]), want_last, rtol=1e-5)
        np.testing.assert_allclose(float(rep.boot[1, 0]), boot[1, 0], rtol=1e-6)

    def test_refresh_retrace_numpy_oracle(self, rng):
        """Backward whole-episode refresh == a literal numpy re-derivation of
        korali's recursion vtg_t = V_t + min(1,rho_t)(r_t + g*vtg_{t+1} - V_t),
        and vtg_next picks the successor (or bootstrap at episode end)."""
        from marlpde_tpu.rl import replay_flat
        rep, batch, _, _ = self._mk(rng)
        # randomize stored metadata to make the recursion non-trivial
        sv = jnp.asarray(rng.standard_normal(rep.sv.shape), jnp.float32)
        rho = jnp.asarray(rng.uniform(0.3, 2.0, rep.rho.shape), jnp.float32)
        rep = rep.replace(sv=sv, rho=rho)
        gamma, scale = 0.9, 2.0
        # sample one experience from each episode: ids 1 (ep0), 5 (ep1, trunc)
        g = jnp.asarray([1, 5], jnp.int32)
        rep2, vtg_next = replay_flat.refresh_retrace(rep, g, self.T, gamma,
                                                     scale)
        svn = np.asarray(sv)[:, 0]
        rn = np.asarray(rep.rewards)[:, 0] / scale
        rhon = np.minimum(np.asarray(rho)[:, 0], 1.0)
        boot = np.asarray(rep.boot)[:, 0]

        def oracle(first, last, seed):
            out, vnext = {}, seed
            for k in range(last, first - 1, -1):
                vt = svn[k] + rhon[k] * (rn[k] + gamma * vnext - svn[k])
                out[k] = vt
                vnext = vt
            return out
        want0 = oracle(0, 4, 0.0)              # terminal episode
        want1 = oracle(5, 6, boot[1])          # truncated: seeded with boot
        got = np.asarray(rep2.vtg)[:, 0]
        for k, v in {**want0, **want1}.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=str(k))
        # vtg_next: successor of g=1 is refreshed vtg[2]; of g=5 is vtg[6]
        np.testing.assert_allclose(float(vtg_next[0, 0]), want0[2], rtol=1e-5)
        np.testing.assert_allclose(float(vtg_next[1, 0]), want1[6], rtol=1e-5)
        # episode-end sample: vtg_next must be the bootstrap (truncated ep 1)
        _, vn_end = replay_flat.refresh_retrace(rep, jnp.asarray([6, 4]),
                                                self.T, gamma, scale)
        np.testing.assert_allclose(float(vn_end[0, 0]), boot[1], rtol=1e-6)
        np.testing.assert_allclose(float(vn_end[1, 0]), 0.0, atol=1e-7)

    def test_off_policy_fraction_counts_replay(self, rng):
        from marlpde_tpu.rl import replay_flat
        rep, _, _, _ = self._mk(rng)
        assert float(replay_flat.off_policy_fraction(rep)) == 0.0
        rep = rep.replace(off=rep.off.at[jnp.asarray([0, 3])].set(True))
        np.testing.assert_allclose(
            float(replay_flat.off_policy_fraction(rep)), 0.2, rtol=1e-6)

    def test_beta_anneals_with_current_lr_against_replay_fraction(self, rng):
        """REFER beta moves by the ANNEALED learning rate toward 1 while the
        replay off-policy fraction is under target, and down when over
        (korali _experienceReplayOffPolicyREFERCurrentBeta update)."""
        from marlpde_tpu.rl import replay_flat
        cfg = vracer.VracerConfig(obs_dim=3, act_dim=1, episode_length=5,
                                  gamma=0.9, lr=1e-2, state_rescaling=False,
                                  reward_rescaling=False, mini_batch_size=4)
        ts = vracer.init_train(cfg, jax.random.key(0))
        batch = self._batch(rng, fill=3)
        # behavior == current policy -> rho = 1 exactly (on-policy replay)
        _, mu_b, sigma_b = vracer.policy_apply(cfg, ts, batch["obs"])
        batch = dict(batch, mu=mu_b, sigma=sigma_b)
        rep = replay_flat.init_flat(32, 32, 1, 3, 1)
        rep = vracer.flat_insert(cfg, ts, rep, batch)
        ts2, rep2, m = vracer.update_experience(cfg, ts, rep, jax.random.key(1))
        # fresh on-policy replay: fraction 0 <= target -> beta rises by lr
        want = (1 - cfg.lr) * cfg.refer_beta + cfg.lr
        np.testing.assert_allclose(float(ts2.beta), want, rtol=1e-5)
        # force the replay far off-policy -> beta must decrease
        rep_off = rep.replace(off=jnp.ones_like(rep.off))
        ts3, _, _ = vracer.update_experience(cfg, ts, rep_off,
                                             jax.random.key(1))
        np.testing.assert_allclose(float(ts3.beta),
                                   (1 - cfg.lr) * cfg.refer_beta, rtol=1e-4)

    def test_winsor_warmup_guard_bounds_cold_spikes(self, rng):
        """ADVICE r4: before the reward accumulator is warm (count <= 1000),
        a spike generation could permanently inflate the cumulative Welford
        scale (the flagship-911 failure).  The warm-up guard clips against
        the batch's own 90th percentile, so one -1e3 spike among ~0.01-scale
        rewards must leave the scale near the bulk's, not the spike's."""
        from marlpde_tpu.rl import running_stats
        cfg = vracer.VracerConfig(obs_dim=3, act_dim=1, episode_length=5,
                                  num_agents=1)
        ts = vracer.init_train(cfg, jax.random.key(0))
        batch = self._batch(rng)
        batch["rewards"] = batch["rewards"] * 0.01
        batch["rewards"] = batch["rewards"].at[0, 2, 0].set(-1e3)
        ts1 = vracer.observe_episodes(cfg, ts, batch)
        scale = float(running_stats.second_moment(ts1.rew_stats))
        assert scale < 1.0, scale          # unclipped spike would give ~260
        assert scale > 1e-4                # bulk statistics still recorded

    def test_state_rescaling_freezes_after_first_update(self, rng):
        """korali computes State Rescaling once from the replay-start buffer;
        observe_episodes must stop accumulating once updates begin."""
        cfg = vracer.VracerConfig(obs_dim=3, act_dim=1, episode_length=5,
                                  num_agents=1)
        ts = vracer.init_train(cfg, jax.random.key(0))
        batch = self._batch(rng, fill=2)
        ts1 = vracer.observe_episodes(cfg, ts, batch)
        assert float(ts1.obs_stats.count) > float(ts.obs_stats.count)
        ts_upd = ts1.replace(n_updates=jnp.asarray(1, jnp.int32))
        ts2 = vracer.observe_episodes(cfg, ts_upd, batch)
        np.testing.assert_array_equal(np.asarray(ts2.obs_stats.mean),
                                      np.asarray(ts_upd.obs_stats.mean))
        assert float(ts2.obs_stats.count) == float(ts_upd.obs_stats.count)

    def test_training_learns_in_experience_mode(self):
        env = registry.make_env("diffusion-simple", N=8, episode_length=60,
                                noise=0.0)
        rl_cfg = trainer.default_rl_config(
            env, width=32, gamma=0.95, init_noise=3.0, lr=1e-3,
            minibatch_mode="experience", mini_batch_size=128,
            replay_start_experiences=480, replay_max_experiences=48000)
        tc = trainer.TrainerConfig(num_envs=8, max_experiences=24000,
                                   reuse_ratio=64.0, max_updates_per_gen=40,
                                   seed=7, log_every=10)
        ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False)
        # diffusion-simple returns sit just below the early-stop threshold
        # (~-5e-5) regardless of skill; survival time is the learning signal
        first = np.mean(hist["mean_ep_len"][:5])
        last = np.mean(hist["mean_ep_len"][-5:])
        assert last > first + 1.0, (first, last)
        assert int(ts.n_updates) > 0

    def test_fused_matches_unfused_experience_mode(self):
        env = registry.make_env("diffusion-simple", N=16, num_agents=1,
                                episode_length=4)
        rl = trainer.default_rl_config(env, width=16,
                                       minibatch_mode="experience",
                                       mini_batch_size=16,
                                       replay_start_experiences=8,
                                       replay_max_experiences=64)
        mk = lambda fused: trainer.TrainerConfig(
            num_envs=2, max_experiences=32, seed=7, fused=fused,
            max_updates_per_gen=4)
        ts_a, rep_a, h_a = trainer.train(env, rl, mk(False), verbose=False)
        ts_b, rep_b, h_b = trainer.train(env, rl, mk(True), verbose=False)
        assert h_a["updates"] == h_b["updates"]
        assert sum(h_b["updates"]) > 0
        for pa, pb in zip(jax.tree.leaves(ts_a.params),
                          jax.tree.leaves(ts_b.params)):
            np.testing.assert_allclose(np.asarray(pa), np.asarray(pb),
                                       rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(rep_a.vtg), np.asarray(rep_b.vtg),
                                   rtol=1e-5, atol=1e-7)


class TestRunningStats:
    def test_matches_numpy(self, rng):
        rs = running_stats.init((3,))
        data = rng.standard_normal((100, 3)).astype(np.float32)
        for chunk in np.split(data, 4):
            rs = running_stats.update(rs, jnp.asarray(chunk))
        # the accumulator starts with one pseudo-count; tolerance accordingly
        np.testing.assert_allclose(np.asarray(rs.mean), data.mean(0), atol=0.05)
        np.testing.assert_allclose(np.asarray(rs.std), data.std(0), atol=0.1)


class TestRealExperienceAccounting:
    def test_counts_live_steps_and_gates_updates(self):
        """count_real_experiences: total_exp increments by the masked step
        count (korali counts only live experiences — diffusion-simple
        episodes early-stop at cumreward<0 after ~10-20 steps), the replay
        gate opens on real experiences, and updates/gen follow the korali
        economics (new real exp * reuse / minibatch)."""
        env = registry.make_env("diffusion-simple", N=8, episode_length=40,
                                noise=0.5)
        rl_cfg = trainer.default_rl_config(
            env, width=8, gamma=0.95, init_noise=3.0,
            minibatch_mode="experience", mini_batch_size=16,
            experiences_between_updates=1.0,
            replay_start_experiences=30, replay_max_experiences=4000)
        tc = trainer.TrainerConfig(
            num_envs=4, max_experiences=200, reuse_ratio=16.0,
            max_updates_per_gen=50, seed=0, count_real_experiences=True,
            fused=True)   # real mode must force the unfused path
        ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False)
        exp = np.asarray(hist["experiences"])
        d_exp = np.diff(np.concatenate([[0], exp]))
        eplen = np.asarray(hist["mean_ep_len"])
        # each generation's increment is the live-step count, not num_envs*T
        np.testing.assert_allclose(d_exp, eplen * tc.num_envs, rtol=1e-6)
        assert exp[-1] < len(exp) * tc.num_envs * env.episode_length
        # korali's exact update ledger: cumulative target is
        # (experienceCount - startSize) / Experiences Between Policy Updates
        # (here expperu = mini_batch/reuse = 1); each generation runs the
        # shortfall vs updates already taken, capped at max_updates_per_gen
        upd = np.asarray(hist["updates"])
        cum = np.cumsum(d_exp)
        done = 0
        for i, u in enumerate(upd):
            if cum[i] < rl_cfg.replay_start_experiences:
                want = 0
            else:
                target = int(cum[i] - rl_cfg.replay_start_experiences)
                want = min(tc.max_updates_per_gen, max(0, target - done))
            assert u == want, (i, u, want)
            done += u


class TestLearning:
    @pytest.mark.slow
    def test_diffusion_simple_policy_improves(self):
        """The minimum end-to-end slice: VRACER on diffusion-simple must beat
        the random-policy baseline within a small training budget."""
        env = registry.make_env("diffusion-simple", N=8, episode_length=60,
                                noise=0.0)
        rl_cfg = trainer.default_rl_config(
            env, width=32, gamma=0.95, init_noise=3.0, lr=1e-3,
            replay_start_experiences=480, replay_max_experiences=48000,
            mini_batch_episodes=4)
        tc = trainer.TrainerConfig(num_envs=8, max_experiences=24000,
                                   reuse_ratio=64.0, max_updates_per_gen=40,
                                   seed=7, log_every=10)
        ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False)
        first = np.mean(hist["mean_return"][:5])
        last = np.mean(hist["mean_return"][-5:])
        assert last > first, (first, last)
        # the learned policy should also survive longer
        assert np.mean(hist["mean_ep_len"][-5:]) > np.mean(hist["mean_ep_len"][:5]) * 0.9

    @pytest.mark.slow
    def test_burger_spectral_closure_learns(self):
        """VRACER on the flagship Burgers spectral-closure workload: the
        cumulative-spectrum error must drop substantially from the random
        policy baseline (observed -0.35 -> -0.06 on this config)."""
        env = registry.make_env(
            "burger", N_dns=64, grid_size=16, num_actions=16, num_agents=1,
            dt=0.01, T=1.0, nu=0.05, episode_length=20, ic_case="turbulence",
            spectral_reward=True, noise=0.0)
        rl_cfg = trainer.default_rl_config(
            env, width=32, lr=1e-3, init_noise=0.5,
            replay_start_experiences=320, replay_max_experiences=16000,
            mini_batch_episodes=4)
        tc = trainer.TrainerConfig(num_envs=16, max_experiences=30000,
                                   reuse_ratio=64.0, max_updates_per_gen=30,
                                   seed=3, log_every=1000)
        ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False)
        first = np.mean(hist["mean_return"][:10])
        last = np.mean(hist["mean_return"][-10:])
        assert last > first * 0.6, (first, last)   # >= 40% error reduction


class TestSaveEpisodes:
    """Save Episode custom setting (burger_environment.py:207-238;
    cumreward filter burger_fd_environment.py:211)."""

    def test_training_dumps_filtered_episodes(self, tmp_path):
        from marlpde_tpu.envs import registry
        from marlpde_tpu.train import trainer
        env = registry.make_env("diffusion-simple", N=16, num_agents=1,
                                episode_length=4)
        tc = trainer.TrainerConfig(num_envs=3, max_experiences=24, seed=0,
                                   save_episodes_dir=str(tmp_path / "eps"),
                                   save_episodes_threshold=-np.inf)
        trainer.train(env, None, tc, verbose=False)
        import glob
        files = sorted(glob.glob(str(tmp_path / "eps" / "episodes_gen*.npz")))
        assert files, "no episode dumps written"
        d = np.load(files[0])
        assert d["actions"].shape[1] == 4          # (B_kept, T, na, act)
        assert d["rewards"].shape[1] == 4
        assert d["cumreward"].shape[0] == d["actions"].shape[0]
        # an impossible threshold filters everything
        tc2 = trainer.TrainerConfig(num_envs=2, max_experiences=8, seed=0,
                                    save_episodes_dir=str(tmp_path / "none"),
                                    save_episodes_threshold=1e18)
        trainer.train(env, None, tc2, verbose=False)
        assert not glob.glob(str(tmp_path / "none" / "*.npz"))

    def test_dumps_include_fields_and_spectra(self, tmp_path):
        """The reference npz accumulates solution fields, spectra and pool
        indices (burger_environment.py:207-238: sgs_u, sgs_Ektt, indeces)."""
        from marlpde_tpu.envs import registry
        from marlpde_tpu.train import trainer
        env = registry.make_env(
            "burger", N_dns=64, grid_size=16, num_actions=16, num_agents=4,
            dt=0.01, T=0.5, nu=0.05, episode_length=5, ic_case="turbulence",
            spectral_reward=True, noise=0.0)
        tc = trainer.TrainerConfig(num_envs=2, max_experiences=10, seed=0,
                                   save_episodes_dir=str(tmp_path / "eps"),
                                   save_episodes_threshold=-np.inf)
        trainer.train(env, None, tc, verbose=False)
        import glob
        files = sorted(glob.glob(str(tmp_path / "eps" / "episodes_gen*.npz")))
        assert files
        d = np.load(files[0])
        assert d["fields"].shape == (2, 5, 16)      # sgs_u: (B, T, N)
        assert d["ektt"].shape == (2, 5, 16)        # sgs_Ektt
        assert d["indeces"].shape == (2,)           # DNS pool indices
        assert np.isfinite(d["fields"]).all()


class TestFusedGeneration:
    """Fused one-dispatch generation == unfused loop (same RNG stream)."""

    def test_fused_matches_unfused(self):
        from marlpde_tpu.envs import registry
        from marlpde_tpu.train import trainer
        env = registry.make_env("diffusion-simple", N=16, num_agents=1,
                                episode_length=4)
        rl = trainer.default_rl_config(env, width=16,
                                       replay_start_experiences=8,
                                       replay_max_experiences=64)
        mk = lambda fused: trainer.TrainerConfig(
            num_envs=2, max_experiences=32, seed=7, fused=fused)
        ts_a, rep_a, h_a = trainer.train(env, rl, mk(False), verbose=False)
        ts_b, rep_b, h_b = trainer.train(env, rl, mk(True), verbose=False)
        assert h_a["updates"] == h_b["updates"]
        assert sum(h_b["updates"]) > 0, "updates never ran; test is vacuous"
        np.testing.assert_allclose(
            np.asarray(ts_a.n_updates), np.asarray(ts_b.n_updates))
        for pa, pb in zip(jax.tree.leaves(ts_a.params),
                          jax.tree.leaves(ts_b.params)):
            np.testing.assert_allclose(np.asarray(pa), np.asarray(pb),
                                       rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(h_a["mean_return"], h_b["mean_return"],
                                   rtol=1e-6)


class TestBlowupContainment:
    """-inf blowup rewards (burger_environment.py:200 parity) must not poison
    the learner: reward_floor clamps them inside VRACER only."""

    def test_training_survives_env_blowups(self):
        # dforce=False (actions scaled by d2udx2, Burger.py:445-450) blows up
        # LES under random exploration — exactly the failure seen in training
        env = registry.make_env(
            "burger", N_dns=64, grid_size=16, num_actions=16, num_agents=4,
            dt=0.01, T=1.0, nu=0.02, episode_length=20, ic_case="turbulence",
            spectral_reward=True, noise=0.0, dforce=False)
        rl_cfg = trainer.default_rl_config(
            env, width=16, init_noise=3.0,
            replay_start_experiences=40, replay_max_experiences=4000,
            mini_batch_episodes=2)
        tc = trainer.TrainerConfig(num_envs=4, max_experiences=800,
                                   seed=0, max_updates_per_gen=10)
        ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False)
        # some episodes must actually have blown up for this test to bite
        assert min(hist["mean_return"]) == -np.inf
        # ...yet the learner stays finite and the policy keeps acting
        for leaf in jax.tree.leaves(ts.params):
            assert np.all(np.isfinite(np.asarray(leaf)))
        assert hist["mean_ep_len"][-1] > 1.0
        assert int(ts.n_updates) > 0

    def test_reward_floor_disabled_reproduces_poisoning(self):
        env = registry.make_env(
            "burger", N_dns=64, grid_size=16, num_actions=16, num_agents=4,
            dt=0.01, T=1.0, nu=0.02, episode_length=20, ic_case="turbulence",
            spectral_reward=True, noise=0.0, dforce=False)
        # the negative control disables the WHOLE containment stack: floor
        # off AND winsor off (the round-5 warm-up guard would otherwise
        # median-clip the -inf out of the cold-phase statistics on its own)
        rl_cfg = trainer.default_rl_config(
            env, width=16, init_noise=3.0, reward_floor=-np.inf,
            reward_stat_winsor=0.0,
            replay_start_experiences=40, replay_max_experiences=4000,
            mini_batch_episodes=2)
        tc = trainer.TrainerConfig(num_envs=4, max_experiences=800,
                                   seed=0, max_updates_per_gen=10)
        ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False)
        finite = all(np.all(np.isfinite(np.asarray(l)))
                     for l in jax.tree.leaves(ts.params))
        assert not finite, "expected NaN poisoning with containment disabled"


class TestSigmaMax:
    """Optional exploration-sigma ceiling (networks.VracerNet.sigma_max):
    inf = korali-faithful unbounded; finite = HARD min cap (exact identity
    below the ceiling — an iex=3 policy under cap 5 still starts at 3)."""

    def test_unbounded_default_matches_iex_at_init(self):
        from marlpde_tpu.rl import networks
        net = networks.VracerNet(act_dim=2, width=8, init_noise=0.7)
        obs = jnp.zeros((3, 4))
        p = net.init(jax.random.key(0), obs)
        _, _, sigma = net.apply(p, obs)
        np.testing.assert_allclose(np.asarray(sigma), 0.7, rtol=1e-4)

    def test_cap_bounds_sigma(self, rng):
        from marlpde_tpu.rl import networks
        net = networks.VracerNet(act_dim=2, width=8, init_noise=0.5,
                                 sigma_max=2.0)
        obs = jnp.asarray(rng.standard_normal((64, 4)) * 50)
        p = net.init(jax.random.key(1), obs[:1])
        # inflate the sigma head to force a large raw output
        p = jax.tree.map(lambda a: a * 30.0, p)
        _, _, sigma = net.apply(p, obs)
        assert float(sigma.max()) <= 2.0 + 1e-6
        # sigmas below the cap are EXACTLY unaffected (min, not tanh)
        net2 = networks.VracerNet(act_dim=2, width=8, init_noise=3.0,
                                  sigma_max=5.0)
        p2 = net2.init(jax.random.key(2), obs[:1])
        _, _, s2 = net2.apply(p2, obs)
        np.testing.assert_allclose(np.asarray(s2), 3.0, rtol=1e-4)

    def test_config_threads_through_policy(self):
        cfg = vracer.VracerConfig(obs_dim=4, act_dim=1, width=8,
                                  init_noise=0.3, sigma_max=1.5,
                                  state_rescaling=False)
        ts = vracer.init_train(cfg, jax.random.key(0))
        _, _, sigma = vracer.policy_apply(cfg, ts, jnp.zeros((2, 1, 4)))
        assert float(sigma.max()) <= 1.5


class TestBestCheckpoint:
    def test_best_saved_by_test_return(self, tmp_path):
        from marlpde_tpu.envs import registry
        from marlpde_tpu.utils import checkpoint as ckpt
        env = registry.make_env("diffusion-simple", N=8, episode_length=6,
                                noise=0.0)
        rl = trainer.default_rl_config(env, width=8,
                                       replay_start_experiences=12)
        tc = trainer.TrainerConfig(num_envs=2, max_experiences=60, seed=0,
                                   testing_frequency=1, testing_episodes=2,
                                   checkpoint_dir=str(tmp_path))
        ts, rep, hist = trainer.train(env, rl, tc, verbose=False)
        import json as _json
        assert (tmp_path / "best" / "latest.pkl").exists()
        meta = _json.load(open(tmp_path / "best" / "best.json"))
        assert meta["test_return"] == max(hist["test_return"])
        back = ckpt.load_train_state(str(tmp_path / "best"), rl)
        assert back is not None


class TestScaleRobustKnobs:
    """sigma-relative mean parameterization + dimension-normalized cutoff
    (the round-4 REFER scale fixes; rationale at VracerConfig.mu_param /
    cutoff_dim_norm)."""

    def _cfg(self, **kw):
        return vracer.VracerConfig(obs_dim=6, act_dim=4, num_agents=1,
                                   episode_length=8, **kw)

    def test_sigma_relative_mu_starts_at_zero(self):
        cfg = self._cfg(mu_param="sigma_relative", init_noise=1e-3)
        ts = vracer.init_train(cfg, jax.random.PRNGKey(0))
        obs = jax.random.normal(jax.random.PRNGKey(1), (5, 6))
        _, mu, sigma = vracer.make_net(cfg).apply(ts.params, obs)
        np.testing.assert_allclose(np.asarray(mu), 0.0)
        np.testing.assert_allclose(np.asarray(sigma), 1e-3 + 1e-5, rtol=1e-4)

    def test_sigma_relative_param_tree_matches_absolute(self):
        # creation order is pinned so checkpoints can never cross-load
        # swapped mean/sigma heads (networks.VracerNet.__call__ NB comment)
        ca = self._cfg()
        cs = self._cfg(mu_param="sigma_relative")
        ta = vracer.init_train(ca, jax.random.PRNGKey(0))
        ts = vracer.init_train(cs, jax.random.PRNGKey(0))
        sa = jax.tree.map(lambda a: a.shape, ta.params)
        ss = jax.tree.map(lambda a: a.shape, ts.params)
        assert jax.tree_util.tree_structure(sa) == jax.tree_util.tree_structure(ss)

    def test_sigma_relative_mu_grad_is_sigma_scaled(self):
        # d mu / d (head kernel) carries the sigma factor: gradients at
        # iex=1e-3 and iex=1.0 differ by exactly 1e-3 at zero-init
        mus = {}
        for iex in (1e-3, 1.0):
            cfg = self._cfg(mu_param="sigma_relative", init_noise=iex)
            ts = vracer.init_train(cfg, jax.random.PRNGKey(0))
            obs = jax.random.normal(jax.random.PRNGKey(1), (3, 6))
            g = jax.grad(lambda p: vracer.make_net(cfg).apply(p, obs)[1].sum())(
                ts.params)
            leaves, _ = jax.tree_util.tree_flatten(
                jax.tree.map(lambda a: np.abs(np.asarray(a)).sum(), g))
            mus[iex] = sum(leaves)
        # sigma_floor (1e-5) shifts the exact ratio slightly
        np.testing.assert_allclose(mus[1e-3], 1e-3 * mus[1.0], rtol=2e-2)

    def test_rho_temper_exponents(self):
        np.testing.assert_allclose(vracer._rho_temper(self._cfg(cutoff_dim_norm=True)),
                                   0.5)                 # d = 4
        cfg1 = vracer.VracerConfig(obs_dim=3, act_dim=1, cutoff_dim_norm=True)
        np.testing.assert_allclose(vracer._rho_temper(cfg1), 1.0)  # korali at d=1
        cfg_mac = vracer.VracerConfig(obs_dim=6, act_dim=4, num_agents=4,
                                      cutoff_dim_norm=True,
                                      multi_agent_correlation=True)  # d = 16
        np.testing.assert_allclose(vracer._rho_temper(cfg_mac), 0.25)
        np.testing.assert_allclose(vracer._rho_temper(self._cfg()), 1.0)  # off

    def test_tempered_rho_is_root_of_joint(self):
        # rho under cutoff_dim_norm equals (joint rho) ** (1/sqrt(d))
        key = jax.random.PRNGKey(3)
        a = jax.random.uniform(key, (7, 1, 4), minval=-2.0, maxval=2.0)
        mu = jnp.zeros((7, 1, 4)); mu_b = 0.3 + mu
        sg = jnp.full((7, 1, 4), 0.7); sg_b = jnp.full((7, 1, 4), 0.5)
        raw, _ = vracer._joint_rho(self._cfg(), a, mu, sg, mu_b, sg_b)
        tmp, _ = vracer._joint_rho(self._cfg(cutoff_dim_norm=True),
                                   a, mu, sg, mu_b, sg_b)
        np.testing.assert_allclose(np.asarray(tmp),
                                   np.asarray(raw) ** 0.5, rtol=1e-5)
