"""KS oracle-headroom study (VERDICT r4 Missing #1b / Next #1b).

Question: does the N=32 KS LES have any exploitable headroom over the
uncontrolled baseline under the env's spectral reward, and how large is the
exact subgrid forcing relative to the exploration scales probed so far?

Oracle forcing.  Filtering the KS equation u_t + u_xx + u_xxxx + 0.5(u^2)_x=0
to the coarse grid (sharp spectral cutoff at g/2 modes, the env's
restrict_modes) gives the exact coarse equation
    ub_t + ub_xx + ub_xxxx + 0.5(ub^2)_x = Pi,
    Pi = 0.5 d/dx[ ub^2 - (u^2)b ]           (the a-priori SGS term; the
reference extracts the FD-derivative version of the same quantity in
KS.py:385-409 / analysis.diagnostics.compute_sgs_ks).  Injecting Pi as the
action forcing makes the LES track the filtered DNS exactly up to ETDRK4
time-discretization error, so its spectral-reward score is the attainable
ceiling for the env's action channel.

Protocols evaluated per grid size (g in 16, 24, 32):
  * uncontrolled              — the baseline every KS run has lost to
  * oracle@macro              — Pi(t) sampled once per macro-step (held for
                                n_intermediate substeps), the action protocol
                                a policy actually has (ks_environment loop)
  * oracle@substep            — Pi(t) refreshed every solver substep (upper
                                bound; not reachable by the macro-step protocol)
Score: the env's cumulative spectral reward, which telescopes to
-rel_err(t_end) (burger_environment.py:172-176 form, ks_environment.py:98-100).

Also reported: rms/max amplitude of Pi vs the exploration scales probed
(iex 1e-3 .. 1e-1) — the quantitative form of REFER_SCALE.md's
"corrections at the reference's exploration scale cannot reach the
subgrid-term amplitude".

CPU float64 throughout (no jax device work).  Writes
results/ks_oracle_r5.json and prints a summary table.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from marlpde_tpu.solvers import ks  # noqa: E402  (host-side coeffs only)

L = 22.0
DT = 0.25
N_DNS = 1024
T_TRANSIENT = 50.0
T_SIM = 500.0
SEED = 42
EPISODE_LENGTH = 500


def etdrk4_step_factory(N: int):
    cfg = ks.KSConfig(N=N, L=L, dt=DT)
    E, E2, Q, f1, f2, f3, gk = ks.etdrk4_coeffs(cfg)

    def nl(z):
        uz = np.fft.irfft(z, N)
        return gk * np.fft.rfft(uz * uz)

    def step(rv, F=None):
        """One ETDRK4 step on the rfft half-spectrum; F = rfft(forcing field),
        entering every phi-term exactly as solvers/ks.py:173-175 (KS.py:264-267)."""
        Nv = nl(rv)
        a = E2 * rv + Q * Nv
        Na = nl(a)
        b = E2 * rv + Q * Na
        Nb = nl(b)
        c = E2 * a + Q * (2.0 * Nb - Nv)
        Nc = nl(c)
        if F is None:
            return E * rv + Nv * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3
        return E * rv + (Nv + F) * f1 + 2.0 * (Na + Nb + 2.0 * F) * f2 + (Nc + F) * f3

    return step


def build_dns():
    """Transient + production DNS, identical to ks_env._make_dns_pool_host."""
    rng = np.random.default_rng([SEED, 0])
    u = 1e-3 * rng.standard_normal(N_DNS)
    step = etdrk4_step_factory(N_DNS)
    rv = np.fft.rfft(u)
    for _ in range(int(T_TRANSIENT / DT)):
        rv = step(rv)
    u0 = np.fft.irfft(rv, N_DNS)
    rv = np.fft.rfft(u0)
    nsteps = int(T_SIM / DT)
    uu = np.empty((nsteps + 1, N_DNS))
    rvv = np.empty((nsteps + 1, N_DNS // 2 + 1), complex)
    uu[0], rvv[0] = u0, rv
    for n in range(nsteps):
        rv = step(rv)
        uu[n + 1] = np.fft.irfft(rv, N_DNS)
        rvv[n + 1] = rv
    return uu, rvv


def restrict(rv_dns, g):
    """Spectral restriction DNS->LES on half-spectra, burger_environment.py:110-112
    convention: keep modes 0..g/2, amplitude scale g/N."""
    return rv_dns[..., : g // 2 + 1] * (g / N_DNS)


def oracle_forcing(u_dns_frame, g):
    """Exact SGS forcing Pi on the g-point grid (docstring derivation), as an
    rfft half-spectrum: Pi_hat = gk_c * ((u^2)b_hat - (ub^2)_hat)."""
    rv = np.fft.rfft(u_dns_frame)
    ub = np.fft.irfft(restrict(rv, g), g)
    u2b_hat = restrict(np.fft.rfft(u_dns_frame ** 2), g)
    kc = np.fft.rfftfreq(g, L / (2 * np.pi * g))
    gk_c = -0.5j * kc
    return gk_c * (u2b_hat - np.fft.rfft(ub * ub)), ub


def cumulative_spectrum(rv, N):
    """Ek_kt row = 0.5|v|^2/N*dx on modes 0..g/2-1 (Burger.py:560-576 convention)."""
    dx = L / N
    return 0.5 * np.abs(rv) ** 2 / N * dx


def clark_features(u, g):
    """Per-gridpoint closure features from a COARSE field u (g,): the env's own
    observables (centered dudx, d2udx2 — KS.py:369-383) and their Clark-model
    product ub_x*ub_xx (the leading term of the gradient/Clark SGS expansion
    (u^2)b - ub^2 ~ C*Delta^2*(ub_x)^2, whose 0.5 d/dx is ~ C*Delta^2*ub_x*ub_xx)."""
    dx = L / g
    up, um = np.roll(u, -1), np.roll(u, 1)
    dudx = (up - um) / (2 * dx)
    d2udx2 = (up - 2 * u + um) / dx ** 2
    return np.stack([dudx, d2udx2, dudx * d2udx2, u, u * dudx], axis=-1)


def fit_apriori(uu_dns, g):
    """Ridge-fit Pi ~ clark_features over the filtered DNS trajectory; returns
    (weights, per-feature corr, model corr)."""
    X, Y = [], []
    for n in range(0, uu_dns.shape[0] - 1, 10):
        Fh, ub = oracle_forcing(uu_dns[n], g)
        X.append(clark_features(ub, g))
        Y.append(np.fft.irfft(Fh, g))
    X = np.concatenate(X, 0)
    Y = np.concatenate(Y, 0).ravel()
    feats = ["dudx", "d2udx2", "dudx*d2udx2", "u", "u*dudx"]
    corr = {f: float(np.corrcoef(X[:, i], Y)[0, 1]) for i, f in enumerate(feats)}
    lam = 1e-8 * np.trace(X.T @ X) / X.shape[1]
    w = np.linalg.solve(X.T @ X + lam * np.eye(X.shape[1]), X.T @ Y)
    pred = X @ w
    corr["model"] = float(np.corrcoef(pred, Y)[0, 1])
    return w, corr


def run_les(g, uu_dns, rvv_dns, mode, dns_ek_ktt, clip=None, w=None):
    """Roll the g-point LES for nsteps from the restricted DNS IC.

    mode: 'uncontrolled' | 'oracle_macro' | 'oracle_substep' | 'clark_macro'
    ('clark_macro' = the fitted state-feedback closure w @ clark_features of
    the LES's OWN field, refreshed per macro-step — a policy realizable from
    the env state, hence a lower bound on what RL could express).
    Returns (-rel_err(t) trajectory, forcing rms stats)."""
    nsteps = uu_dns.shape[0] - 1
    n_int = nsteps // EPISODE_LENGTH
    step = etdrk4_step_factory(g)
    rv = restrict(rvv_dns[0], g)
    ek_sum = cumulative_spectrum(rv, g)
    rel_errs = np.empty(nsteps)
    f_rms = []
    F = None
    for n in range(nsteps):
        if mode == "oracle_substep" or (mode == "oracle_macro" and n % n_int == 0):
            F, _ = oracle_forcing(uu_dns[n], g)
            if clip is not None:
                f_phys = np.fft.irfft(F, g)
                f_rms.append(float(np.sqrt(np.mean(f_phys ** 2))))
                f_phys = np.clip(f_phys, -clip, clip)
                F = np.fft.rfft(f_phys)
        elif mode == "clark_macro" and n % n_int == 0:
            u_les = np.fft.irfft(rv, g)
            f_phys = np.clip(clark_features(u_les, g) @ w, -5.0, 5.0)
            f_rms.append(float(np.sqrt(np.mean(f_phys ** 2))))
            F = np.fft.rfft(f_phys)
        rv = step(rv, F)
        ek_sum = ek_sum + cumulative_spectrum(rv, g)
        sgs_ektt = ek_sum[1: g // 2] / (n + 2)
        dns_ektt = dns_ek_ktt[n + 1, 1: g // 2]
        rel_errs[n] = np.mean((np.abs(dns_ektt - sgs_ektt) / dns_ektt) ** 2)
    return rel_errs, f_rms


def main():
    print("[ks_oracle] building DNS (fp64, host)...", flush=True)
    uu, rvv = build_dns()
    nsteps = uu.shape[0] - 1
    out = {"config": dict(N_dns=N_DNS, L=L, dt=DT, t_sim=T_SIM, seed=SEED,
                          episode_length=EPISODE_LENGTH)}
    for g in (32, 24, 16):
        # DNS cumulative-mean spectrum on the first g/2 modes
        ek = cumulative_spectrum(rvv[:, : g // 2], N_DNS)
        dns_ek_ktt = np.cumsum(ek, 0) / np.arange(1, nsteps + 2)[:, None]
        res = {}
        w, corr = fit_apriori(uu, g)
        res["apriori_corr"] = corr
        res["clark_weights"] = [float(v) for v in w]
        print(f"[ks_oracle] g={g} a-priori corr: " +
              " ".join(f"{k}={v:+.3f}" for k, v in corr.items()), flush=True)
        for mode in ("uncontrolled", "oracle_macro", "oracle_substep",
                     "clark_macro"):
            rel, frms = run_les(g, uu, rvv, mode, dns_ek_ktt, clip=5.0, w=w)
            res[mode] = {
                "score": -float(rel[-1]),           # telescoped cumulative reward
                "rel_err_final": float(rel[-1]),
                "rel_err_mid": float(rel[nsteps // 2]),
            }
            if frms:
                res[mode]["forcing_rms_mean"] = float(np.mean(frms))
                res[mode]["forcing_rms_max"] = float(np.max(frms))
            print(f"[ks_oracle] g={g} {mode:16s} score={-rel[-1]:.6g} "
                  f"(rel_err final {rel[-1]:.3e})", flush=True)
        # amplitude context: Pi rms over the trajectory (unclipped)
        pis = [np.fft.irfft(oracle_forcing(uu[n], g)[0], g)
               for n in range(0, nsteps, 50)]
        pis = np.stack(pis)
        res["pi_rms"] = float(np.sqrt(np.mean(pis ** 2)))
        res["pi_absmax"] = float(np.abs(pis).max())
        out[f"g{g}"] = res
        print(f"[ks_oracle] g={g} Pi rms={res['pi_rms']:.4g} "
              f"absmax={res['pi_absmax']:.4g}", flush=True)
    os.makedirs("results", exist_ok=True)
    with open("results/ks_oracle_r5.json", "w") as f:
        json.dump(out, f, indent=1)
    print("[ks_oracle] wrote results/ks_oracle_r5.json", flush=True)


if __name__ == "__main__":
    main()
