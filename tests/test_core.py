"""Core-layer unit tests: grids, spectral ops, basis, ICs, interpolation.

Oracles are independent numpy re-derivations of the reference formulas
(cited per test), not imports of the reference code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from marlpde_tpu.core import basis, grids, ic, interp, spectral


class TestGrid:
    def test_wavenumbers_match_fftfreq_convention(self):
        # Burger.py:161: k = fftfreq(N, L/(2*pi*N))
        g = grids.Grid(N=32, L=2 * np.pi)
        np.testing.assert_allclose(g.k, np.fft.fftfreq(32, 2 * np.pi / (2 * np.pi * 32)))
        assert g.k[1] == pytest.approx(1.0)

    def test_nonunit_domain(self):
        g = grids.Grid(N=64, L=100.0)
        np.testing.assert_allclose(g.k[1], 2 * np.pi / 100.0)
        assert g.dx == pytest.approx(100.0 / 64)

    def test_hashable_static(self):
        assert grids.Grid(8, 1.0) == grids.Grid(8, 1.0)
        assert hash(grids.Grid(8, 1.0)) == hash(grids.Grid(8, 1.0))


class TestSpectral:
    def test_energy_spectrum(self, rng):
        # Burger.py:562: Ek = 0.5*Re(conj(v)v)/N*dx
        u = rng.standard_normal(64)
        v = np.fft.fft(u)
        got = spectral.energy_spectrum(jnp.asarray(v), dx=0.1)
        np.testing.assert_allclose(got, 0.5 * np.abs(v) ** 2 / 64 * 0.1, rtol=1e-12)

    def test_cumulative_mean(self, rng):
        a = rng.standard_normal((10, 4))
        got = spectral.cumulative_mean(jnp.asarray(a))
        want = np.cumsum(a, 0) / np.arange(1, 11)[:, None]
        np.testing.assert_allclose(got, want, rtol=1e-12)

    @pytest.mark.parametrize("g", [8, 15, 32])
    def test_restrict_modes_matches_reference_slicing(self, rng, g):
        # burger_environment.py:111 (note floor division of negative numerator)
        N = 64
        v = rng.standard_normal(N) + 1j * rng.standard_normal(N)
        want = np.concatenate((v[: (g + 1) // 2], v[-(g - 1) // 2:])) * g / N
        got = spectral.restrict_modes(jnp.asarray(v), g)
        assert got.shape == (g,)
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_restriction_of_low_mode_signal_is_exact(self):
        # A field with only low modes survives restriction exactly
        N, gsz = 256, 32
        x = np.linspace(0, 2 * np.pi, N, endpoint=False)
        u = np.sin(4 * x) + 0.3 * np.cos(7 * x)
        v = np.fft.fft(u)
        v0 = spectral.restrict_modes(jnp.asarray(v), gsz)
        u_coarse = np.real(np.fft.ifft(np.asarray(v0)))
        xc = np.linspace(0, 2 * np.pi, gsz, endpoint=False)
        np.testing.assert_allclose(u_coarse, np.sin(4 * xc) + 0.3 * np.cos(7 * xc), atol=1e-12)

    def test_phase_shift_translates_field(self):
        N = 64
        gr = grids.Grid(N=N, L=2 * np.pi)
        u = np.sin(3 * gr.x)
        v = np.fft.fft(u)
        # exp(1j*2*pi*offset*k) with k in integer wavenumbers translates by 2*pi*offset
        off = 0.05
        shifted = np.real(np.fft.ifft(np.asarray(spectral.phase_shift(jnp.asarray(v), off, jnp.asarray(gr.k)))))
        np.testing.assert_allclose(shifted, np.sin(3 * (gr.x + 2 * np.pi * off)), atol=1e-10)

    def test_sharp_filter(self, rng):
        gr = grids.Grid(N=64, L=2 * np.pi)
        v = rng.standard_normal(64) + 1j * rng.standard_normal(64)
        got = np.asarray(spectral.sharp_filter(jnp.asarray(v), jnp.asarray(gr.k), 16))
        assert np.all(got[np.abs(gr.k) > 16] == 0)
        np.testing.assert_allclose(got[np.abs(gr.k) <= 16], v[np.abs(gr.k) <= 16])


class TestBasis:
    @pytest.mark.parametrize("kind", ["uniform", "hat"])
    @pytest.mark.parametrize("M", [1, 4, 8, 32])
    def test_partition_of_unity(self, kind, M):
        # Burger.py:203 asserts sum(basis, axis=0) == 1
        b = basis.make_basis(M, 32, 2 * np.pi, kind)
        np.testing.assert_allclose(b.sum(0), 1.0)
        assert b.shape == (M, 32)

    def test_uniform_blocks(self):
        b = basis.make_basis(4, 8, 2 * np.pi, "uniform")
        np.testing.assert_array_equal(b[0], [1, 1, 0, 0, 0, 0, 0, 0])
        np.testing.assert_array_equal(b[3], [0, 0, 0, 0, 0, 0, 1, 1])

    def test_uniform_requires_divisibility(self):
        with pytest.raises(AssertionError):
            basis.make_basis(3, 8, 2 * np.pi, "uniform")

    def test_hat_matches_reference_loop(self):
        # re-derivation of Burger.py:190-195
        M, N, L = 8, 32, 2 * np.pi
        x = np.linspace(0, L, N, endpoint=False)
        dx = L / (M - 1)
        want = np.stack([basis.hat(x, i * dx, dx) for i in range(M)])
        np.testing.assert_allclose(basis.make_basis(M, N, L, "hat"), want)


class TestTurbulenceIC:
    def _reference_turbulence(self, tseed, offset, N, L):
        """Literal re-derivation of Burger.py:227-259."""
        x = np.linspace(0, L, N, endpoint=False)
        rng = 123456789 + tseed
        a, c, m = 1103515245, 12345, 2**13
        u0 = np.ones(N)
        for k in range(1, N):
            rng = (a * rng + c) % m
            phase = rng / m * 2.0 * np.pi
            Ek = 5 ** (-5 / 3) if k <= 5 else k ** (-5 / 3)
            u0 += np.sqrt(2 * Ek) * np.sin(k * 2 * np.pi * (x + offset) / L + phase)
        idx = 0
        criterion = np.sqrt(np.sum((u0 - 1.0) ** 2) / N)
        while criterion < 0.65 or criterion > 0.75:
            u0 *= 0.7 / criterion
            criterion = np.sqrt(np.sum((u0 - 1.0) ** 2) / N)
            idx += 1
            if idx > 100:
                break
        return u0

    @pytest.mark.parametrize("tseed", [42, 43, 1337])
    def test_bit_parity_with_reference_lcg(self, tseed):
        N, L = 512, 2 * np.pi
        x = jnp.asarray(np.linspace(0, L, N, endpoint=False))
        got = np.asarray(ic.burger_turbulence(tseed, 0.0, x, L))
        want = self._reference_turbulence(tseed, 0.0, N, L)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    def test_rms_in_band(self):
        N, L = 1024, 2 * np.pi
        x = jnp.asarray(np.linspace(0, L, N, endpoint=False))
        u0 = np.asarray(ic.burger_turbulence(7, 0.1, x, L))
        crit = np.sqrt(np.sum((u0 - 1) ** 2) / N)
        assert 0.6 < crit < 0.8  # Burger.py:259 asserts this band

    def test_vmappable_over_seeds(self):
        N, L = 128, 2 * np.pi
        x = jnp.asarray(np.linspace(0, L, N, endpoint=False))
        seeds = jnp.arange(4)
        batch = jax.vmap(lambda s: ic.burger_turbulence(s, 0.0, x, L))(seeds)
        assert batch.shape == (4, N)
        singles = np.stack([ic.burger_turbulence(int(s), 0.0, x, L) for s in range(4)])
        np.testing.assert_allclose(np.asarray(batch), singles, rtol=1e-10)


class TestOtherICs:
    def test_sinus(self):
        g = grids.Grid(64)
        np.testing.assert_allclose(
            ic.burger_sinus(0.0, jnp.asarray(g.x), g.L),
            np.sin(4 * np.pi * g.x / g.L), atol=1e-12)

    def test_diffusion_box(self):
        g = grids.Grid(64)
        u0 = np.asarray(ic.diffusion_box(0.0, jnp.asarray(g.x), g.L))
        want = np.zeros(64)
        want[np.abs(g.x - g.L / 2) < g.L / 8] = 1.0
        np.testing.assert_array_equal(u0, want)

    def test_ks_noise_scale(self):
        u0 = ic.ks_noise(jax.random.key(0), 4096, dtype=jnp.float64)
        assert np.std(np.asarray(u0)) == pytest.approx(1e-3, rel=0.1)

    def test_laplace(self):
        g = grids.Grid(32)
        x = jnp.asarray(g.x)
        np.testing.assert_allclose(ic.laplace_ic("one", x), np.ones(32))
        np.testing.assert_allclose(ic.laplace_force("sin", None, 0.0, x, g.L),
                                   np.sin(g.x * 2 * np.pi / g.L), atol=1e-12)


class TestInterp:
    def test_linear_interp_on_grid_points_is_identity(self, rng):
        y = jnp.asarray(rng.standard_normal(32))
        x = jnp.asarray(np.linspace(0, 2 * np.pi, 32, endpoint=False))
        np.testing.assert_allclose(interp.linear_interp(y, x, 2 * np.pi), y, atol=1e-12)

    def test_cubic_interp_on_grid_points_is_identity(self, rng):
        y = jnp.asarray(rng.standard_normal(32))
        x = jnp.asarray(np.linspace(0, 2 * np.pi, 32, endpoint=False))
        np.testing.assert_allclose(interp.cubic_interp(y, x, 2 * np.pi), y, atol=1e-10)

    def test_cubic_interp_exact_for_smooth_signal(self):
        # cubic spline of a resolved sinus is accurate to O(h^4)
        N, L = 64, 2 * np.pi
        x = np.linspace(0, L, N, endpoint=False)
        y = jnp.asarray(np.sin(3 * x))
        xq = jnp.asarray(np.linspace(0, L, 257, endpoint=False))
        got = np.asarray(interp.cubic_interp(y, xq, L))
        np.testing.assert_allclose(got, np.sin(3 * np.asarray(xq)), atol=5e-5)

    def test_batched_frames(self, rng):
        y = jnp.asarray(rng.standard_normal((5, 32)))
        xq = jnp.asarray(np.array([0.1, 1.3, 5.0]))
        out = interp.cubic_interp(y, xq, 2 * np.pi)
        assert out.shape == (5, 3)
        np.testing.assert_allclose(out[2], interp.cubic_interp(y[2], xq, 2 * np.pi), atol=1e-12)

    def test_shifted_query_points(self):
        x = jnp.asarray(np.array([0.0, 3.0, 6.0]))
        got = np.asarray(interp.shifted_query_points(x, 1.0, 2 * np.pi))
        np.testing.assert_allclose(got, [1.0, 4.0, 7.0 - 2 * np.pi])

    def test_frame_index(self):
        assert interp.frame_index(0.5, 0.001, 5001) == 500
        assert interp.frame_index(0.5000000001, 0.001, 5001) == 500


class TestUniformSplineFastPath:
    """periodic_spline_eval_uniform == periodic_spline_eval on the standard
    shifted coarse grid (the burger-fd per-substep reward hot path)."""

    def test_matches_general_path(self):
        rng = np.random.default_rng(7)
        N, Q, L = 1024, 256, 2 * np.pi
        y = jnp.asarray(rng.standard_normal(N), jnp.float64)
        M = interp.periodic_spline_m(y)
        xq0 = jnp.arange(Q) * (L / Q)
        for off in [0.0, 0.1234, -0.77, 3.9, L - 1e-6, -L + 0.3, L / N * 2.5]:
            newx = interp.shifted_query_points(xq0, jnp.asarray(off), L)
            want = np.asarray(interp.periodic_spline_eval(y, M, newx, L))
            got = np.asarray(interp.periodic_spline_eval_uniform(
                y, M, jnp.asarray(off), L, Q))
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                                       err_msg=f"off={off}")

    def test_zero_offset_is_strided_subsample(self):
        rng = np.random.default_rng(8)
        y = jnp.asarray(rng.standard_normal(64), jnp.float64)
        M = interp.periodic_spline_m(y)
        got = np.asarray(interp.periodic_spline_eval_uniform(y, M, 0.0,
                                                             2 * np.pi, 16))
        np.testing.assert_allclose(got, np.asarray(y)[::4], atol=1e-12)

    def test_under_vmap_per_env_offsets(self):
        rng = np.random.default_rng(9)
        N, Q, L, B = 128, 32, 2 * np.pi, 5
        ys = jnp.asarray(rng.standard_normal((B, N)), jnp.float64)
        Ms = interp.periodic_spline_m(ys)
        offs = jnp.asarray(rng.uniform(-L, L, B))
        fast = jax.vmap(lambda y, M, o: interp.periodic_spline_eval_uniform(
            y, M, o, L, Q))(ys, Ms, offs)
        xq0 = jnp.arange(Q) * (L / Q)
        for b in range(B):
            newx = interp.shifted_query_points(xq0, offs[b], L)
            want = np.asarray(interp.periodic_spline_eval(ys[b], Ms[b], newx, L))
            np.testing.assert_allclose(np.asarray(fast[b]), want,
                                       rtol=1e-9, atol=1e-9)
