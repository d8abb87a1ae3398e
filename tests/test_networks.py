"""Plain-JAX networks (rl/networks.py, ddp/pipeline.ClosureNet), the pytree
base class of every state (utils/pytree.py) and the compile-cache helper
(utils/compile_cache.py)."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from marlpde_tpu.rl import networks


def _np_forward(p, obs, n_hidden, init_noise, sigma_floor=1e-5):
    """numpy re-derivation: tanh trunk, value/mean/softplus-sigma heads."""
    p = {k: {n: np.asarray(a, np.float64) for n, a in v.items()}
         for k, v in p["params"].items()}
    h = np.asarray(obs, np.float64)
    for i in range(n_hidden):
        h = np.tanh(h @ p[f"Dense_{i}"]["kernel"] + p[f"Dense_{i}"]["bias"])
    head = lambda i: h @ p[f"Dense_{i}"]["kernel"] + p[f"Dense_{i}"]["bias"]
    raw = head(n_hidden + 2)
    sigma = np.log1p(np.exp(raw)) * init_noise / np.log(2.0) + sigma_floor
    return head(n_hidden)[..., 0], head(n_hidden + 1), sigma


class TestVracerNet:
    @pytest.mark.parametrize("n_hidden", [1, 2, 3])
    def test_param_tree_layout(self, n_hidden):
        net = networks.VracerNet(act_dim=3, width=16, n_hidden=n_hidden)
        p = net.init(jax.random.key(0), jnp.zeros((1, 5)))
        assert list(p) == ["params"]
        names = [f"Dense_{i}" for i in range(n_hidden + 3)]
        assert sorted(p["params"]) == sorted(names)
        shapes = {k: (v["kernel"].shape, v["bias"].shape)
                  for k, v in p["params"].items()}
        assert shapes["Dense_0"] == ((5, 16), (16,))
        for i in range(1, n_hidden):
            assert shapes[f"Dense_{i}"] == ((16, 16), (16,))
        # head order: value, mean, sigma
        assert shapes[f"Dense_{n_hidden}"] == ((16, 1), (1,))
        assert shapes[f"Dense_{n_hidden + 1}"] == ((16, 3), (3,))
        assert shapes[f"Dense_{n_hidden + 2}"] == ((16, 3), (3,))

    def test_initial_distributions(self):
        """LeCun-normal truncated kernels (std sqrt(1/fan_in); the unit
        normal is cut at +-2 and rescaled by 1/0.8796 to keep that std),
        zero biases, zero sigma head (and zero mean head when
        sigma_relative)."""
        fan_in = 256
        for mu_param in ("absolute", "sigma_relative"):
            net = networks.VracerNet(act_dim=4, width=256, mu_param=mu_param)
            p = net.init(jax.random.key(1), jnp.zeros((1, fan_in)))["params"]
            k0 = np.asarray(p["Dense_0"]["kernel"])
            std = np.sqrt(1.0 / fan_in)
            assert abs(k0.std() / std - 1.0) < 0.05
            assert np.abs(k0).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
            for v in p.values():
                np.testing.assert_array_equal(np.asarray(v["bias"]), 0.0)
            np.testing.assert_array_equal(np.asarray(p["Dense_4"]["kernel"]), 0)
            mu_k = np.asarray(p["Dense_3"]["kernel"])
            assert (mu_param == "sigma_relative") == (not mu_k.any())

    @pytest.mark.parametrize("init_noise", [1e-3, 0.1, 3.0])
    def test_sigma_equals_init_noise_at_init(self, rng, init_noise):
        net = networks.VracerNet(act_dim=2, width=32, init_noise=init_noise)
        obs = jnp.asarray(rng.standard_normal((7, 6)))
        _, _, sigma = net.apply(net.init(jax.random.key(2), obs), obs)
        np.testing.assert_allclose(np.asarray(sigma), init_noise + 1e-5,
                                   rtol=1e-6)

    @pytest.mark.parametrize("n_hidden", [1, 2])
    def test_forward_matches_numpy(self, rng, n_hidden):
        net = networks.VracerNet(act_dim=3, width=24, n_hidden=n_hidden,
                                 init_noise=0.4)
        obs = rng.standard_normal((11, 2, 5))
        p = net.init(jax.random.key(3), jnp.asarray(obs))
        # non-zero heads so every term of the forward is exercised
        p = jax.tree.map(lambda a: a + 0.05 * jnp.ones_like(a), p)
        v, mu, sigma = net.apply(p, jnp.asarray(obs))
        v_ref, mu_ref, s_ref = _np_forward(p, obs, n_hidden, 0.4)
        assert v.shape == (11, 2) and mu.shape == sigma.shape == (11, 2, 3)
        np.testing.assert_allclose(np.asarray(v), v_ref, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(mu), mu_ref, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(sigma), s_ref, rtol=1e-10)

    def test_sigma_relative_mean_scales_with_sigma(self, rng):
        net = networks.VracerNet(act_dim=2, width=8, init_noise=0.2,
                                 mu_param="sigma_relative")
        obs = jnp.asarray(rng.standard_normal((4, 3)))
        p = net.init(jax.random.key(4), obs)
        p = jax.tree.map(lambda a: a + 0.1, p)
        _, mu, sigma = net.apply(p, obs)
        absolute = dataclasses.replace(net, mu_param="absolute")
        _, mu_abs, _ = absolute.apply(p, obs)
        np.testing.assert_allclose(np.asarray(mu),
                                   np.asarray(mu_abs * sigma), rtol=1e-12)

    def test_flax_layout_pickle_loads(self, tmp_path, rng):
        """A parameter tree pickled in the flax.linen Dense layout (plain
        nested dicts of numpy arrays, as checkpoints store them) loads and
        evaluates."""
        w, obs_dim, A = 8, 3, 2
        r = np.random.default_rng(5)
        tree = {"params": {
            "Dense_0": {"kernel": r.standard_normal((obs_dim, w)),
                        "bias": r.standard_normal(w)},
            "Dense_1": {"kernel": r.standard_normal((w, w)),
                        "bias": r.standard_normal(w)},
            "Dense_2": {"kernel": r.standard_normal((w, 1)),
                        "bias": r.standard_normal(1)},
            "Dense_3": {"kernel": r.standard_normal((w, A)),
                        "bias": r.standard_normal(A)},
            "Dense_4": {"kernel": r.standard_normal((w, A)),
                        "bias": r.standard_normal(A)}}}
        path = tmp_path / "params.pkl"
        path.write_bytes(pickle.dumps(tree))
        back = jax.tree.map(jnp.asarray, pickle.loads(path.read_bytes()))
        net = networks.VracerNet(act_dim=A, width=w, init_noise=0.3)
        obs = rng.standard_normal((5, obs_dim))
        v, mu, sigma = net.apply(back, jnp.asarray(obs))
        v_ref, mu_ref, s_ref = _np_forward(tree, obs, 2, 0.3)
        np.testing.assert_allclose(np.asarray(v), v_ref, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(mu), mu_ref, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(sigma), s_ref, rtol=1e-10)
        # and the tree is what init builds, shape for shape
        fresh = net.init(jax.random.key(0), jnp.zeros((1, obs_dim)))
        assert (jax.tree.map(np.shape, fresh)
                == jax.tree.map(np.shape, tree))


class TestClosureNet:
    def test_layout_and_swish_forward(self, rng):
        from marlpde_tpu.ddp import pipeline
        net = pipeline.ClosureNet(n_out=6, width=10, n_hidden=2)
        x = rng.standard_normal((4, 6))
        p = net.init(jax.random.key(0), jnp.asarray(x))
        shapes = {k: v["kernel"].shape for k, v in p["params"].items()}
        assert shapes == {"Dense_0": (6, 128), "Dense_1": (128, 10),
                          "Dense_2": (10, 10), "Dense_3": (10, 6)}
        q = {k: {n: np.asarray(a) for n, a in v.items()}
             for k, v in p["params"].items()}
        swish = lambda z: z / (1.0 + np.exp(-z))
        h = x
        for i in range(3):
            h = swish(h @ q[f"Dense_{i}"]["kernel"] + q[f"Dense_{i}"]["bias"])
        ref = h @ q["Dense_3"]["kernel"] + q["Dense_3"]["bias"]
        np.testing.assert_allclose(np.asarray(net.apply(p, jnp.asarray(x))),
                                   ref, rtol=1e-10)


class TestPyTreeNode:
    def _cls(self):
        from marlpde_tpu.rl import running_stats
        return running_stats.RunningStats

    def test_frozen_and_replace(self):
        RS = self._cls()
        s = RS(mean=jnp.zeros(3), m2=jnp.ones(3), count=jnp.asarray(0.0))
        with pytest.raises(dataclasses.FrozenInstanceError):
            s.count = 1.0
        s2 = s.replace(count=jnp.asarray(5.0))
        assert float(s2.count) == 5.0 and float(s.count) == 0.0
        assert s2.mean is s.mean

    def test_flatten_unflatten_under_jit(self):
        RS = self._cls()
        s = RS(mean=jnp.arange(3.0), m2=jnp.ones(3), count=jnp.asarray(2.0))
        leaves, treedef = jax.tree_util.tree_flatten(s)
        assert len(leaves) == 3
        back = jax.tree_util.tree_unflatten(treedef, leaves)
        assert isinstance(back, RS)

        @jax.jit
        def f(st):
            return st.replace(count=st.count + 1, mean=st.mean * 2)

        out = f(s)
        assert isinstance(out, RS)
        np.testing.assert_array_equal(np.asarray(out.mean), [0.0, 2.0, 4.0])
        assert float(out.count) == 3.0
        # properties of the subclass survive
        assert out.std.shape == (3,)

    def test_pickle_round_trip(self):
        from marlpde_tpu.rl import vracer
        cfg = vracer.VracerConfig(obs_dim=3, act_dim=1, width=4)
        ts = jax.tree.map(np.asarray, vracer.init_train(cfg, jax.random.key(0)))
        back = pickle.loads(pickle.dumps(ts))
        assert type(back) is type(ts)
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(ts))
        for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)


class TestCompileCache:
    @pytest.fixture
    def restore_config(self):
        keys = ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_entry_size_bytes",
                "jax_persistent_cache_min_compile_time_secs")
        saved = {k: getattr(jax.config, k) for k in keys}
        yield
        for k, v in saved.items():
            jax.config.update(k, v)

    def test_env_var_is_honoured(self, monkeypatch, tmp_path, restore_config):
        from marlpde_tpu.utils import compile_cache
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.setup() == str(tmp_path)
        # the variable is JAX's own: no other directory is set in code
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_lies_inside_the_checkout(self, monkeypatch,
                                              restore_config):
        from marlpde_tpu.utils import compile_cache
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.setup()
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            networks.__file__)))
        repo = os.path.dirname(root)
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
