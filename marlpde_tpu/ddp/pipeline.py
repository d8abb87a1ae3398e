"""Supervised DDP closure subproject: DNS data generation -> spectral
filtering -> ANN closure training -> a-posteriori LES -> transfer learning.

Parity targets (reference ddp/):
  * Stochastic_Burgers_DNS.py: L=100, nu=0.02, N=1024, dt=0.01, s=20, ABCN;
    forcing redrawn every s steps with amplitude A=sqrt(2)*1e-2,
    f = sum_k r1*A/sqrt(k*s*dt)*cos(2*pi*k*x/L + 2*pi*r2), k=1..3  (:28-60)
  * helpers.filter_bar: spectral box filter N -> n_sub                (:6-12)
  * helpers.calc_bar:  tau = 0.5*(bar(u^2) - bar(u)^2),
    PI = (tau - roll(tau,1))/dx, dx = L/NY                            (:15-29)
  * Turbulence_train / ddp_train_and_test: MLP n->250x6(swish)->n,
    Adam, mse, normalized in/out                                      (:66-79)
  * a-posteriori rollout: ABCN with the NN subgrid term integrated by
    2nd-order Adams-Bashforth: -fft(dt*(3/2*pi_n - 1/2*pi_{n-1}))     (:120-130)
  * Transfer_Learning.py: freeze trunk, retrain head at a new Re      (:93-102)

Everything runs on-device: the DNS generator is a lax.scan, training uses
optax, the a-posteriori LES embeds the MLP in the scan body (no
model.predict host round-trips).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from marlpde_tpu.core import spectral
from marlpde_tpu.rl import networks


# --------------------------------------------------------------- data generation

@dataclasses.dataclass(frozen=True)
class DdpConfig:
    L: float = 100.0
    nu: float = 0.02
    N: int = 1024
    dt: float = 0.01
    s: int = 20              # LES/DNS time-step ratio
    n_les: int = 128
    forcing_amp: float = float(np.sqrt(2) * 1e-2)


def generate_dns(cfg: DdpConfig, n_steps: int, key, u0=None):
    """Stochastic Burgers DNS (ABCN); returns (U_DNS (T+1, N), f_store (T+1, N)).

    Forcing is redrawn every cfg.s steps (Stochastic_Burgers_DNS.py:50-60).
    """
    N, L, dt = cfg.N, cfg.L, cfg.dt
    x = jnp.linspace(0.0, L, N, endpoint=False)
    k = jnp.asarray(np.fft.fftfreq(N, L / (2 * np.pi * N)))
    k1 = 1j * k
    C = 0.5 * (k**2) * cfg.nu * dt          # note k2 = -k^2; C = -0.5*k2*nu*dt

    if u0 is None:
        key, kic = jax.random.split(key)
        phase = jax.random.normal(kic) * 2.0 * np.pi
        u0 = jnp.sin(2.0 * np.pi * 2.0 * x / L + phase)
    v0 = spectral.fft(u0)
    fn_old0 = k1 * spectral.fft(0.5 * u0 * u0)

    n_blocks = n_steps // cfg.s
    keys = jax.random.split(key, n_blocks)

    def draw_forcing(kb):
        r = jax.random.normal(kb, (2, 3))
        kk = jnp.arange(1, 4, dtype=u0.dtype)
        amp = r[0] * cfg.forcing_amp / jnp.sqrt(kk * cfg.s * dt)
        ph = 2.0 * np.pi * kk[:, None] * x[None, :] / L + 2.0 * np.pi * r[1][:, None]
        return (amp[:, None] * jnp.cos(ph)).sum(0)

    def block(carry, kb):
        u, v, fn_old = carry
        f = draw_forcing(kb)
        fnf = spectral.fft(f)

        def sub(c, _):
            u_, v_, fo_ = c
            Fn = k1 * spectral.fft(0.5 * u_ * u_)
            v_ = ((1.0 - C) * v_ - 0.5 * dt * (3.0 * Fn - fo_) + dt * fnf) / (1.0 + C)
            u_ = spectral.irfft_real(v_)
            return (u_, v_, Fn), u_

        (u, v, fn_old), us = jax.lax.scan(sub, (u, v, fn_old), None, length=cfg.s)
        fs = jnp.broadcast_to(f, (cfg.s, N))
        return (u, v, fn_old), (us, fs)

    (_, _, _), (us, fs) = jax.lax.scan(block, (u0, v0, fn_old0), keys)
    U = jnp.concatenate([u0[None], us.reshape(-1, N)], 0)
    F = jnp.concatenate([jnp.zeros((1, N), u0.dtype), fs.reshape(-1, N)], 0)
    return U, F


# ------------------------------------------------------------------- filtering

def filter_bar(u, n_sub):
    """Spectral box filter N -> n_sub grid (ddp/helpers.py:6-12), batched."""
    v = spectral.fft(u)
    return spectral.irfft_real(spectral.restrict_modes(v, n_sub))


def calc_bar(U, F, n_sub, L=100.0):
    """(u_bar, PI, f_bar) per ddp/helpers.py:15-29; leading axes batched."""
    u_bar = filter_bar(U, n_sub)
    f_bar = filter_bar(F, n_sub)
    u2_bar = filter_bar(U * U, n_sub)
    tau = 0.5 * (u2_bar - u_bar * u_bar)
    dx = L / n_sub
    pi = (tau - jnp.roll(tau, 1, axis=-1)) / dx
    return u_bar, pi, f_bar


def normalize_data(data):
    std = jnp.std(data)
    mean = jnp.mean(data)
    return (data - mean) / std, mean, std


def shift_augment(key, a, b):
    """Random periodic shift augmentation (ddp/helpers.py:44-50), paired."""
    n, width = a.shape
    shifts = jax.random.randint(key, (n,), 0, width)
    idx = (jnp.arange(width)[None, :] + shifts[:, None]) % width
    return jnp.take_along_axis(a, idx, 1), jnp.take_along_axis(b, idx, 1)


# ------------------------------------------------------------------- ANN model

@dataclasses.dataclass(frozen=True)
class ClosureNet:
    """n_bar -> 250 x n_hidden (swish) -> n_bar (ddp_train_and_test.py:66-74).

    Parameters follow networks.VracerNet's Dense_i layout: Dense_0 is the
    128-wide input layer, Dense_1..Dense_{n_hidden} the hidden layers and
    Dense_{n_hidden+1} the linear head."""

    n_out: int = 128
    width: int = 250
    n_hidden: int = 6

    def init(self, key, x):
        sizes = ([x.shape[-1], 128] + [self.width] * self.n_hidden
                 + [self.n_out])
        keys = jax.random.split(key, len(sizes) - 1)
        return {"params": {
            f"Dense_{i}": networks.dense_init(keys[i], sizes[i], sizes[i + 1])
            for i in range(len(sizes) - 1)}}

    def apply(self, params, x):
        p = params["params"]
        h = x
        for i in range(self.n_hidden + 1):
            h = jax.nn.swish(networks.dense(p[f"Dense_{i}"], h))
        return networks.dense(p[f"Dense_{self.n_hidden + 1}"], h)


@dataclasses.dataclass
class ClosureModel:
    params: dict
    mean_in: float
    std_in: float
    mean_out: float
    std_out: float
    net: ClosureNet

    def predict(self, u_bar):
        z = (u_bar - self.mean_in) / self.std_in
        out = self.net.apply(self.params, z)
        return out * self.std_out + self.mean_out


def train_closure(u_bar, pi, key, epochs: int = 100, batch_size: int = 200,
                  lr: float = 1e-3, net: Optional[ClosureNet] = None,
                  params=None, trainable_mask=None, verbose=False):
    """Train the ANN closure u_bar -> PI with Adam/mse
    (Turbulence_train.py:89-108).  `trainable_mask` (pytree of bools) enables
    transfer learning with frozen layers (Transfer_Learning.py:93-102)."""
    n = u_bar.shape[-1]
    net = net or ClosureNet(n_out=n)
    x, mean_in, std_in = normalize_data(u_bar)
    y, mean_out, std_out = normalize_data(pi)
    if params is None:
        key, kp = jax.random.split(key)
        params = net.init(kp, x[:1])

    tx = optax.adam(lr)
    if trainable_mask is not None:
        tx = optax.chain(optax.masked(optax.set_to_zero(),
                                      jax.tree.map(lambda m: not m, trainable_mask)),
                         tx)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            pred = net.apply(p, xb)
            return jnp.mean((pred - yb) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    n_samples = x.shape[0]
    steps_per_epoch = max(n_samples // batch_size, 1)
    loss = jnp.inf
    for ep in range(epochs):
        key, ks = jax.random.split(key)
        perm = jax.random.permutation(ks, n_samples)
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            params, opt_state, loss = step(params, opt_state, x[idx], y[idx])
        if verbose and ep % 10 == 0:
            print(f"[ddp] epoch {ep} loss {float(loss):.6f}")

    return ClosureModel(params=params, mean_in=float(mean_in),
                        std_in=float(std_in), mean_out=float(mean_out),
                        std_out=float(std_out), net=net)


def transfer_mask(params, n_frozen: int = 6):
    """Trainable-mask for transfer learning: freeze the first ``n_frozen``
    Dense layers, retrain the rest — the reference freezes layers 1-6 of its
    8-layer net and retrains the 7th hidden layer + linear head
    (Transfer_Learning.py:93-102 'trainable = False' rows)."""
    def trainable(path, _):
        for p in path:
            if hasattr(p, "key") and str(p.key).startswith("Dense_"):
                return int(str(p.key).split("_")[1]) >= n_frozen
        return True
    return jax.tree.map_with_path(trainable, params)


def head_only_mask(params):
    """Trainable-mask freezing everything except the last Dense layer (a
    stricter variant of transfer_mask; kept for head-probing experiments)."""
    layers = sorted(params["params"].keys())
    return transfer_mask(params, n_frozen=int(layers[-1].split("_")[1]))


def apriori_eval(model: "ClosureModel", u_bar, pi_true):
    """A-priori evaluation (Turbulence_predict_prior.py): predict PI from
    filtered fields and score against the true SGS term.

    Returns dict(mse, correlation)."""
    import numpy as _np
    pred = _np.asarray(model.predict(jnp.asarray(u_bar)))
    true = _np.asarray(pi_true)
    mse = float(_np.mean((pred - true) ** 2))
    corr = float(_np.corrcoef(pred.ravel(), true.ravel())[0, 1])
    return dict(mse=mse, correlation=corr)


# ------------------------------------------------------------- a-posteriori LES

def aposteriori_rollout(model: ClosureModel, cfg: DdpConfig, u_init, u_prev,
                        f_bar_seq, n_steps: int):
    """LES with the ANN closure inside the ABCN step (ddp_train_and_test.py:120-130).

    Subgrid term integrated with 2nd-order Adams-Bashforth:
      uRHS -= fft(dt*(3/2*pi_n - 1/2*pi_{n-1})).
    f_bar_seq: (n_steps, n) filtered forcing per LES step.
    Returns uu (n_steps+1, n).
    """
    n = cfg.n_les
    L, nu = cfg.L, cfg.nu
    dt = cfg.s * cfg.dt                          # LES runs at s*dt
    rdtype = u_init.dtype
    cdtype = jnp.result_type(rdtype, jnp.complex64)
    k = np.fft.fftfreq(n, L / (2 * np.pi * n))
    k1 = jnp.asarray(1j * k, cdtype)
    D2 = jnp.asarray(k * k, rdtype)
    D2x = jnp.asarray(1.0 + 0.5 * dt * nu * k * k, rdtype)

    v = spectral.fft(u_init)
    v_old = spectral.fft(u_prev)
    pi_prev = model.predict(u_prev)

    def step(carry, f):
        u, v, u_old, v_old, pi_prev = carry
        pi_n = model.predict(u)
        F = k1 * spectral.fft(0.5 * u * u)
        F0 = k1 * spectral.fft(0.5 * u_old * u_old)
        rhs = (-0.5 * dt * (3.0 * F - F0) - 0.5 * dt * nu * (D2 * v) + v
               + dt * spectral.fft(f)
               - spectral.fft(dt * (1.5 * pi_n - 0.5 * pi_prev)))
        v_new = rhs / D2x
        u_new = spectral.irfft_real(v_new)
        return (u_new, v_new, u, v, pi_n), u_new

    (uf, *_), us = jax.lax.scan(
        step, (u_init, v, u_prev, v_old, pi_prev), f_bar_seq[:n_steps])
    return jnp.concatenate([u_init[None], us], 0)
