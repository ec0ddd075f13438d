"""System-level MLP-ensemble surrogate (the JAX package's ``surrogate/mlp.py``).

One network maps all normalized system inputs to all normalized outputs
(scalars, and the SVD latents of compressed fields) plus a failure logit. An
ensemble of K members is held as stacked weights ``(K, din, dout)`` and applied
with batched products (``torch.baddbmm``), one product per layer for all
members; the prediction is the ensemble mean. The members train jointly, each on
its own minibatches, with AdamW under a cosine schedule (the update
``optax.adamw(optax.cosine_decay_schedule(...))`` computes).

Products run in full float32 on the card: TF32 is switched off around every
forward and backward pass (:func:`full_fp32`), as the JAX package pins
``Precision.HIGHEST``: reduced-precision products add ~0.4% per-output jitter,
which cut a stretch-move MCMC's acceptance from 0.30 to 0.01 in the JAX
package's measurements.

State (``to_state``/``from_state``, :func:`generate_training_data`'s caches) is
numpy arrays in the JAX package's layout, so weights and data move between the
two packages with no conversion.
"""

from __future__ import annotations

import contextlib
import math
import pickle
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hallthrusterpem_tpu_torch.core.dataset import as_numpy, to_numpy
from hallthrusterpem_tpu_torch.surrogate.component import regrid_to_compression

__all__ = ["MLPSurrogate", "EnsembleMLP", "generate_training_data", "load_training_caches", "full_fp32",
           "make_optimizer", "train_step"]


def load_training_caches(run_dir, system, pattern: str = "{name}_mlp_train_data*.pkl",
                         drop: tuple = ("discharge_current_trace", "trace_times")):
    """Concatenate every labeled training-data cache in ``run_dir`` (either
    package's). The labeled inputs ride along inside the cached outputs, so the
    pairing cannot drift. Returns ``(samples, outputs)`` dicts of numpy arrays.
    """
    in_names = [v.name for v in system.inputs()]
    paths = sorted(Path(run_dir).glob(pattern.format(name=system.name)))
    if not paths:
        raise FileNotFoundError(f"no training-data caches under {run_dir}")
    all_s, all_o = [], []
    for path in paths:
        with open(path, "rb") as fd:
            cache = pickle.load(fd)
        outputs, n_done = cache["outputs"], cache["done"]
        if not all(k in outputs for k in in_names):
            raise ValueError(f"{path}: cache lacks input columns")
        all_s.append({k: np.asarray(outputs[k])[:n_done] for k in in_names})
        all_o.append({k: np.asarray(v)[:n_done] for k, v in outputs.items() if k not in drop})
        system.logger.info("%s: %d labeled samples", path.name, n_done)
    samples = {k: np.concatenate([s[k] for s in all_s]) for k in all_s[0]}
    outputs = {k: np.concatenate([o[k] for o in all_o]) for k in all_o[0]
               if all(k in o for o in all_o)}
    return samples, outputs


def generate_training_data(system, n: int, seed: int = 0, chunk: int = 1024,
                           cache_path=None, use_pdf=("calibration", "nuisance"),
                           domain_filter=None) -> tuple[dict, dict]:
    """Sample the prior and label ``n`` points with the true coupled model
    (``System.predict(use_model="best")`` on the system's device), in resumable
    chunks.

    Each completed chunk is appended to ``cache_path``, a pickle of numpy
    arrays (the float outputs of ndim >= 1, inputs included), so an interrupted
    run restarts where it left off. Returns ``(samples, outputs)`` as numpy.
    """
    samples = as_numpy(system.sample_inputs(n, seed=seed, use_pdf=list(use_pdf), domain_filter=domain_filter))
    done, outputs = 0, {}
    if cache_path is not None and Path(cache_path).exists():
        with open(cache_path, "rb") as fd:
            d = pickle.load(fd)
        if d.get("n") == n and d.get("seed") == seed:
            done, outputs = d["done"], d["outputs"]
            system.logger.info("resuming training-data generation at %d/%d", done, n)
    while done < n:
        m = min(chunk, n - done)
        batch = {k: v[done:done + m] for k, v in samples.items()}
        out = as_numpy(system.predict(batch, use_model="best"))
        out = {k: v for k, v in out.items() if v.dtype.kind == "f" and v.ndim >= 1}
        for k, v in out.items():
            outputs[k] = v if k not in outputs else np.concatenate([outputs[k], v], axis=0)
        done += m
        system.logger.info("training data: %d/%d evaluated", done, n)
        if cache_path is not None:
            tmp = Path(cache_path).with_suffix(".tmp")
            with open(tmp, "wb") as fd:
                pickle.dump({"n": n, "seed": seed, "done": done, "outputs": outputs}, fd)
            tmp.replace(cache_path)
    return samples, outputs


@contextlib.contextmanager
def full_fp32():
    """Float32 products in full float32 (no TF32) inside the block, restored
    after it: the counterpart of JAX's ``Precision.HIGHEST``."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 products are still enabled")
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


class EnsembleMLP(torch.nn.Module):
    """K stacked members: ``weights[l]`` (K, din, dout), ``biases[l]`` (K, 1, dout);
    tanh-form GELU between layers (``jax.nn.gelu``'s default), none after the
    last."""

    def __init__(self, params: Sequence[tuple]):
        """``params``: (weight, bias) arrays or tensors per layer, copied."""
        super().__init__()
        self.weights = torch.nn.ParameterList([torch.nn.Parameter(torch.tensor(np.asarray(w))) for w, _ in params])
        self.biases = torch.nn.ParameterList([torch.nn.Parameter(torch.tensor(np.asarray(b))) for _, b in params])

    @property
    def members(self) -> int:
        return self.weights[0].shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (K, n, D), a minibatch per member, or (n, D), shared -> (K, n, P+1)."""
        h = x.expand(self.members, *x.shape) if x.dim() == 2 else x
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = torch.baddbmm(b, h, w)
            if i < last:
                h = F.gelu(h, approximate="tanh")
        return h

    def to_numpy(self) -> list:
        return [(w.detach().cpu().numpy(), b.detach().cpu().numpy()) for w, b in zip(self.weights, self.biases)]


def _cosine(steps: int, alpha: float = 0.02):
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` as a factor of ``lr``."""
    return lambda t: alpha + (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(t, steps) / steps))


def make_optimizer(net: EnsembleMLP, lr: float, steps: int, weight_decay: float) -> tuple:
    """AdamW (eps 1e-8, decay decoupled from the gradient) on a cosine schedule
    from ``lr`` to ``0.02 lr`` over ``steps``: ``(optimizer, scheduler)``."""
    opt = torch.optim.AdamW(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, _cosine(steps))


def train_step(net: EnsembleMLP, opt_state: tuple, xb, yb, mb, fb, cls_weight: float = 0.2):
    """One optimizer step on member-specific minibatches ``xb`` (K, b, D), targets
    ``yb`` (K, b, P), element mask ``mb`` (K, b, P) and failure labels ``fb``
    (K, b): loss = masked MSE + ``cls_weight`` x BCE of the failure logit.
    Returns ``(loss, mse, bce)`` as tensors (no host sync)."""
    opt, sched = opt_state
    with full_fp32():
        out = net(xb)
        pred, logit = out[..., :-1], out[..., -1]
        mse = torch.sum(mb * (pred - yb) ** 2) / torch.clamp_min(torch.sum(mb), 1.0)
        bce = F.binary_cross_entropy_with_logits(logit, fb)
        loss = mse + cls_weight * bce
        opt.zero_grad(set_to_none=True)
        loss.backward()
    opt.step()
    sched.step()
    return loss.detach(), mse.detach(), bce.detach()


class MLPSurrogate:
    """End-to-end surrogate of a coupled :class:`~hallthrusterpem_tpu_torch.core.system.System`.

    ``predict`` returns denormalized scalars and latent coefficients for compressed
    fields (the contract of ``ComponentSurrogate.predict``) as tensors on the
    system's device, where the ensemble trains and runs; ``reconstruct_field``
    maps latents back to profiles, and ``as_torch_fn`` returns a pure prediction
    function on tensors.
    """

    kind = "mlp"

    def __init__(self, system, hidden: Sequence[int] = (256, 256, 256),
                 ensemble: int = 8, seed: int = 0, log_outputs="auto"):
        self.system = system
        self.device = system.device
        self.hidden = tuple(int(h) for h in hidden)
        self.ensemble = int(ensemble)
        self.seed = int(seed)
        self.in_vars = list(system.inputs())
        self.out_slices = None  # built lazily (raw-field widths come from data)
        self.n_out = None
        self.n_in = len(self.in_vars)
        self.net: Optional[EnsembleMLP] = None
        self.x_mu = self.x_sd = None
        self.y_mu = self.y_sd = None
        #: scalar outputs regressed in log10 space ("auto": any all-positive
        #: scalar whose p99/p1 ratio in the training data exceeds 5)
        self.log_outputs = log_outputs
        self.log_names: Optional[set] = None if log_outputs == "auto" else set(log_outputs or ())
        self.train_info: dict = {}

    # ------------------------------------------------------------------ layout
    def _build_layout(self, outputs: Optional[dict] = None, spec=None):
        """Output slices ``(var, start, size, kind)`` over all system outputs.

        Compressed fields become latent blocks; uncompressed fields ("raw") take
        their width from the data (or a saved layout spec); everything else is a
        scalar column.
        """
        if self.out_slices is not None:
            return
        spec_sizes = {name: (size, kind) for name, size, kind in (spec or [])}
        self.out_slices = []
        start = 0
        for var in self.system.outputs():
            if var.compression is not None and var.compression.projection is not None:
                size, kind = var.compression.latent_size, "latent"
            elif var.name in spec_sizes:
                size, kind = spec_sizes[var.name]
            elif outputs is not None and var.name in outputs:
                arr = np.asarray(outputs[var.name])
                size = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
                kind = "raw" if size > 1 else "scalar"
            else:
                size, kind = 1, "scalar"
            self.out_slices.append((var, start, size, kind))
            start += size
        self.n_out = start

    # ------------------------------------------------------------------ packing
    def pack_inputs(self, samples: dict, normalized: bool = False) -> np.ndarray:
        cols = []
        for var in self.in_vars:
            val = np.asarray(to_numpy(samples[var.name]), dtype=np.float64).reshape(-1)
            cols.append(val if normalized else np.asarray(var.normalize(val)))
        return np.stack(cols, axis=1)

    def pack_outputs(self, outputs: dict) -> np.ndarray:
        """Named outputs (numpy) -> ``(N, n_out)`` normalized/compressed matrix (NaN
        rows mark failed samples). Fields are re-gridded onto the compression
        coords when the model grid differs (the ``{var}_coords`` convention)."""
        self._build_layout(outputs)
        n = None
        for var, *_ in self.out_slices:
            if var.name in outputs:
                n = np.asarray(outputs[var.name]).shape[0]
                break
        if n is None:
            raise KeyError("none of the system outputs found in the dataset")
        if self.log_names is None:  # resolve "auto" on the first (training) pack
            # the quantile ratio p99/p1, not max/min: one near-zero sample must
            # not flip an output to log targets
            self.log_names = set()
            for var, start, size, kind in self.out_slices:
                if kind != "scalar" or var.name not in outputs:
                    continue
                val = np.asarray(outputs[var.name], dtype=np.float64).reshape(-1)
                pos = val[np.isfinite(val)]
                if pos.size and (pos > 0).all():
                    p1, p99 = np.percentile(pos, [1, 99])
                    if p1 > 0 and p99 > 5 * p1:
                        self.log_names.add(var.name)
        mat = np.full((n, self.n_out), np.nan)
        for var, start, size, kind in self.out_slices:
            if var.name not in outputs:
                continue
            val = np.asarray(outputs[var.name], dtype=np.float64)
            if kind == "scalar" and var.name in self.log_names:
                # log-space regression target; non-positive values cannot be
                # represented and are masked like failures
                with np.errstate(divide="ignore", invalid="ignore"):
                    mat[:, start] = np.where(val > 0, np.log10(np.maximum(val, 1e-300)), np.nan)
                continue
            if kind == "latent":
                val = regrid_to_compression(var, val, outputs.get(f"{var.name}_coords"))
                normed = np.asarray(var.normalize(val))
                mat[:, start:start + size] = np.asarray(var.compression.compress(normed))
            else:
                mat[:, start:start + size] = np.asarray(var.normalize(val)).reshape(n, size)
        return mat

    # ------------------------------------------------------------------ training
    def _init_params(self, generator: torch.Generator) -> list:
        """He-normal weights drawn from ``generator`` (on the CPU), zero biases."""
        sizes = [self.n_in, *self.hidden, self.n_out + 1]
        params = []
        for din, dout in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((self.ensemble, din, dout), generator=generator) * math.sqrt(2.0 / din)
            params.append((w.float(), torch.zeros((self.ensemble, 1, dout))))
        return params

    def fit(self, samples: dict, outputs: dict, *, steps: int = 6000, batch: int = 2048,
            lr: float = 2e-3, weight_decay: float = 1e-5, cls_weight: float = 0.2,
            val_frac: float = 0.1, normalized: bool = False, verbose: bool = True,
            log_every: int = 500) -> dict:
        """Train the ensemble on a ``(samples, outputs)`` dataset on the
        system's device.

        Failed samples (any non-finite output) contribute only to the failure
        head; finite elements contribute per-element MSE so partially-valid
        rows are still used.
        """
        X = self.pack_inputs(samples, normalized=normalized).astype(np.float32)
        Y = self.pack_outputs(as_numpy(outputs)).astype(np.float32)
        n = X.shape[0]
        fail = ~np.isfinite(Y).all(axis=1)

        self.x_mu = X.mean(axis=0)
        self.x_sd = np.where(X.std(axis=0) > 1e-12, X.std(axis=0), 1.0)
        ok = np.isfinite(Y)
        y_mu = np.zeros(self.n_out, np.float32)
        y_sd = np.ones(self.n_out, np.float32)
        for var, start, size, kind in self.out_slices:
            blk = Y[:, start:start + size]
            m = ok[:, start:start + size]
            if not m.any():
                continue
            mu = np.array([blk[m[:, j], j].mean() if m[:, j].any() else 0.0 for j in range(size)])
            y_mu[start:start + size] = mu
            cen = np.where(m, blk - mu, 0.0)
            if size > 1:
                # one RMS scale per field block: keep the latent/grid columns'
                # relative variance so the loss mirrors the field L2 error
                rms = float(np.sqrt((cen**2).sum() / max(m.sum(), 1)))
                y_sd[start:start + size] = max(rms, 1e-12)
            else:
                sd = float(np.sqrt((cen[:, 0] ** 2).sum() / max(m[:, 0].sum(), 1)))
                y_sd[start] = max(sd, 1e-12)
        self.y_mu, self.y_sd = y_mu, y_sd

        Xs = (X - self.x_mu) / self.x_sd
        Ys = np.where(ok, (np.nan_to_num(Y) - y_mu) / y_sd, 0.0)
        mask = ok.astype(np.float32)

        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_val = max(int(n * val_frac), 1) if val_frac > 0 else 0
        val_idx, tr_idx = perm[:n_val], perm[n_val:]
        dev = self.device
        on_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
        xt, yt, mt, ft = on_dev(Xs[tr_idx]), on_dev(Ys[tr_idx]), on_dev(mask[tr_idx]), on_dev(fail[tr_idx])
        n_tr = len(tr_idx)
        batch = min(batch, n_tr)

        self.net = EnsembleMLP(self._init_params(torch.Generator().manual_seed(self.seed))).to(dev)
        opt_state = make_optimizer(self.net, lr, steps, weight_decay)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        history = []
        for i in range(steps):
            idx = torch.randint(0, n_tr, (self.ensemble, batch), generator=gen, device=dev)
            loss, mse, bce = train_step(self.net, opt_state, xt[idx], yt[idx], mt[idx], ft[idx], cls_weight)
            if verbose and (i % log_every == 0 or i == steps - 1):
                rec = {"step": i, "loss": float(loss), "mse": float(mse), "bce": float(bce)}
                history.append(rec)
                self.system.logger.info("mlp step %d: loss %.4f (mse %.4f, bce %.4f)", i, rec["loss"],
                                        rec["mse"], rec["bce"])

        info = {"n_train": int(n_tr), "n_val": int(n_val), "steps": steps, "batch": batch,
                "fail_frac": float(fail.mean()), "history": history}
        if n_val:
            xv, yv, mv = Xs[val_idx], Ys[val_idx], mask[val_idx]
            raw = self._raw_predict(on_dev(xv)).cpu().numpy()
            num = (mv * (raw[..., :-1] - yv) ** 2).sum()
            info["val_rmse"] = float(np.sqrt(num / max(mv.sum(), 1.0)))
            pf = 1 / (1 + np.exp(-raw[..., -1]))
            info["val_fail_acc"] = float(((pf > 0.5) == fail[val_idx]).mean())
        self.train_info = info
        return info

    # ------------------------------------------------------------------ prediction
    @torch.no_grad()
    def _raw_predict(self, xs: torch.Tensor) -> torch.Tensor:
        """Standardized inputs -> ensemble-mean standardized outputs ``(n, P+1)``
        (regression columns averaged in standardized space; fail logit averaged)."""
        with full_fp32():
            return self.net(xs).mean(dim=0)

    def as_torch_fn(self, training: bool = True, qoi_ind: Optional[Sequence[str]] = None):
        """Pure ``samples (model units) -> outputs`` function on tensors on the
        system's device: scalars denormalized, compressed fields as latent
        coefficients, and ``sys_fail_prob`` (the ``System.as_torch_fn``
        contract). Inputs are taken in float32, as the JAX package's."""
        if self.net is None:
            raise ValueError("MLPSurrogate is not trained")
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
        x_mu, x_sd, y_mu, y_sd = f32(self.x_mu), f32(self.x_sd), f32(self.y_mu), f32(self.y_sd)
        in_vars = list(self.in_vars)
        slices = list(self.out_slices)
        log_names = frozenset(self.log_names or ())
        keep = None if qoi_ind is None else set(qoi_ind)

        def fn(samples: dict) -> dict:
            cols = [v.normalize(torch.as_tensor(samples[v.name], dtype=torch.float32, device=dev)).reshape(-1)
                    for v in in_vars]
            mean = self._raw_predict((torch.stack(cols, dim=1) - x_mu) / x_sd)
            pred = mean[..., :-1] * y_sd + y_mu
            result = {}
            for var, start, size, kind in slices:
                if keep is not None and var.name not in keep:
                    continue
                block = pred[..., start:start + size]
                if kind == "latent":
                    result[var.name] = block
                elif kind == "raw":
                    result[var.name] = var.denormalize(block)
                elif var.name in log_names:
                    result[var.name] = 10.0 ** block[..., 0]
                else:
                    result[var.name] = var.denormalize(block[..., 0])
            result["sys_fail_prob"] = torch.sigmoid(mean[..., -1])
            return result

        return fn

    as_jax_fn = as_torch_fn  # the JAX package's name, for code written against it

    def predict(self, samples: dict, training: bool = False, denormalize: bool = True,
                normalized: bool = False, qoi_ind=None) -> dict:
        """Batched prediction: tensors on the system's device."""
        fn = self.as_torch_fn(qoi_ind=qoi_ind)
        if normalized:
            samples = {v.name: v.denormalize(samples[v.name]) for v in self.in_vars if v.name in samples}
        return fn({k: torch.as_tensor(v, device=self.device).reshape(-1) for k, v in samples.items()})

    def fail_prob(self, samples: dict, normalized: bool = False) -> np.ndarray:
        """Failure-boundary classifier head: P(sample fails the solver guards),
        as a host numpy array (the ``domain_filter`` protocol's type)."""
        return self.predict(samples, normalized=normalized)["sys_fail_prob"].cpu().numpy()

    def reconstruct_field(self, var_name: str, latents):
        for var, start, size, kind in self.out_slices:
            if var.name == var_name and kind == "latent":
                return var.denormalize(var.compression.reconstruct(latents))
        raise KeyError(f"{var_name} is not a compressed field output of {self.system.name}")

    def test_errors(self, xt: dict, yt: dict, targets=None) -> dict:
        """Held-out relative-L2 per target (the MISC trainer's metric: global
        norm ratio for scalars, per-sample mean for fields)."""
        from hallthrusterpem_tpu_torch.surrogate.train import relative_l2

        pred = as_numpy(self.predict(xt))
        errors = {}
        for var, start, size, kind in self.out_slices:
            name = var.name
            if (targets and name not in targets) or name not in yt:
                continue
            ref = np.asarray(yt[name], dtype=np.float64)
            got = np.asarray(pred[name], dtype=np.float64)
            if kind == "latent":
                got = np.asarray(self.reconstruct_field(name, got))
                if got.shape != ref.shape:
                    continue
            errors[name] = relative_l2(got, ref, axis=-1 if ref.ndim > 1 else None)
        return errors

    # ------------------------------------------------------------------ io
    def to_state(self) -> dict:
        """numpy arrays and Python values in the JAX package's layout."""
        return {
            "kind": self.kind, "hidden": self.hidden, "ensemble": self.ensemble,
            "seed": self.seed,
            "params": self.net.to_numpy() if self.net is not None else [],
            "x_mu": np.asarray(self.x_mu) if self.x_mu is not None else None,
            "x_sd": np.asarray(self.x_sd) if self.x_sd is not None else None,
            "y_mu": np.asarray(self.y_mu) if self.y_mu is not None else None,
            "y_sd": np.asarray(self.y_sd) if self.y_sd is not None else None,
            "train_info": {k: v for k, v in self.train_info.items() if k != "history"},
            "layout": [(v.name, size, kind) for v, _, size, kind in (self.out_slices or [])],
            "log_names": sorted(self.log_names or ()),
        }

    @classmethod
    def from_state(cls, state: dict, system) -> "MLPSurrogate":
        surr = cls(system, hidden=state["hidden"], ensemble=state["ensemble"], seed=state["seed"])
        spec = state.get("layout") or []
        surr._build_layout(spec=spec)
        built = [(v.name, size, kind) for v, _, size, kind in surr.out_slices]
        if spec and built != [tuple(s) for s in spec]:
            raise ValueError(f"system outputs {built} do not match saved MLP layout {spec}")
        if state["params"]:
            surr.net = EnsembleMLP([(np.asarray(w), np.asarray(b)) for w, b in state["params"]]).to(surr.device)
        surr.x_mu, surr.x_sd = state["x_mu"], state["x_sd"]
        surr.y_mu, surr.y_sd = state["y_mu"], state["y_sd"]
        surr.log_names = set(state.get("log_names", ()))
        surr.train_info = state.get("train_info", {})
        return surr

    def save(self, path):
        with open(path, "wb") as fd:
            pickle.dump(self.to_state(), fd)

    @classmethod
    def load(cls, path, system) -> "MLPSurrogate":
        with open(Path(path), "rb") as fd:
            return cls.from_state(pickle.load(fd), system)
