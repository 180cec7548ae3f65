"""K-FAC preconditioning before LAMB (counterpart of
bert_pytorch_tpu/optim/kfac.py on one card).

The reference ran K-FAC through an external library's hooks (factor decay
0.95, damping 0.003, kl_clip 0.001, factors every step, inverses every 10
steps, the MLM head and the embeddings skipped). The JAX package
re-implemented it in-framework; this is that implementation's math, in
the unstacked layout (one site a Linear), on one device:

- **Taps** (models/bert.KFACTaps, `config.kfac_taps`): each tapped
  Linear's input `a` and the loss's gradient `g` with respect to its
  output, from the step's own backward pass. The sites are the four
  Linears of every encoder layer, the pooler's dense and the NSP head.
- **Statistics** of a microbatch, in f32 from the compute-dtype taps:
  A = aug(a)^T aug(a) / rows (a column of ones appended: the bias rides
  with the kernel), G = rows * g^T g (undoing the mean loss's 1 / rows),
  stored in `stats_dtype` (--kfac_stats_dtype). The step sums them over
  its microbatches and divides by the accumulation count.
- **Factors**: an EMA, f = d f + (1 - d) s, every `factor_interval`
  steps (and only every `factor_sync_freq` steps when that is above 1),
  kept in f32.
- **Inverses** every `inv_interval` steps, in f32, with factored
  Tikhonov damping: pi = sqrt((tr A / dim A) / (tr G / dim G)), then
  (A + sqrt(damping) pi I)^-1 and (G + sqrt(damping) / pi I)^-1 by
  Cholesky: L^-1 by a triangular solve against I, then L^-T L^-1.
  Stored as `inverse_dtype` (bf16 by default, as the JAX package keeps
  them; the reference kept fp16 ones).
- **Preconditioning**: per site not named in `skip_layers` (a token
  found in the site's port name or its JAX tap path), the kernel and the
  bias jointly: A^-1 [W^T; b] G^-1 in f32, W the port's (out, in)
  weight, so the flax kernel is its transpose. Then every preconditioned
  site is rescaled by kl_clip's nu = min(1, sqrt(kl_clip / (lr^2 |sum g
  . F^-1 g|))) at the schedule's learning rate.

The large products are `torch.matmul` and the factorisation and the
solve `torch.linalg` calls, as the JAX package's are plain XLA products
and `jnp.linalg` calls outside any Pallas kernel. The step
(training/pretrain.build_kfac_pretrain_step) hands LAMB the
preconditioned gradients.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

Site = Dict[str, torch.Tensor]     # {"A": (in+1, in+1), "G": (out, out)}


@dataclasses.dataclass(frozen=True)
class KFACConfig:
    inv_interval: int = 10
    factor_interval: int = 1
    stat_decay: float = 0.95
    damping: float = 0.003
    kl_clip: float = 0.001
    skip_layers: Tuple[str, ...] = ("cls_predictions", "embeddings")
    inverse_dtype: torch.dtype = torch.bfloat16
    # the statistics' dtype; the factors and their EMA stay f32
    stats_dtype: torch.dtype = torch.float32
    factor_sync_freq: int = 1


@dataclasses.dataclass
class KFACState:
    """The preconditioner's state (TrainState.precond_state): factors and
    inverses by site, each {"A", "G"}, and the optimization steps seen."""
    factors: Dict[str, Site]
    inverses: Dict[str, Site]
    count: int = 0

    def state_dict(self) -> Dict:
        """Flat by "<site>/<A|G>", as a checkpoint carries it."""
        return {"count": int(self.count),
                "factors": _flat(self.factors),
                "inverses": _flat(self.inverses)}

    def nbytes(self) -> Tuple[int, int]:
        """(factor bytes, inverse bytes)."""
        return tuple(sum(t.numel() * t.element_size()
                         for site in tree.values() for t in site.values())
                     for tree in (self.factors, self.inverses))


def _flat(tree: Dict[str, Site]) -> Dict[str, torch.Tensor]:
    return {f"{site}/{k}": t for site, d in tree.items()
            for k, t in d.items()}


_LAYER = re.compile(r"^bert\.encoder\.layers\.(\d+)\.(.*)$")


def jax_tap_path(site: str) -> str:
    """The JAX package's tap path of a port site (the unstacked layout):
    bert.encoder.layers.3.attention.qkv -> bert/encoder/layer_3/attention/
    qkv_tap."""
    m = _LAYER.match(site)
    if m:
        site = f"bert/encoder/layer_{m.group(1)}/{m.group(2)}"
    return site.replace(".", "/") + "_tap"


def chol_inverse(mat: torch.Tensor) -> torch.Tensor:
    """The inverse of an SPD matrix by Cholesky: L^-1 by a triangular
    solve against the identity, then L^-T L^-1. A factorization that
    fails (a poisoned step's NaN factors) gives non-finite values and no
    error, as jnp.linalg.cholesky does, and the card is not waited on
    for the check."""
    chol, _ = torch.linalg.cholesky_ex(mat)
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return inv_l.T @ inv_l


def site_shapes(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """(in, out) of each tapped Linear of a model built with
    config.kfac_taps, by site."""
    mods = dict(model.named_modules())
    return {site: (mods[site].in_features, mods[site].out_features)
            for site in model.kfac_sites}


class KFAC:
    """Functional K-FAC over the port's state:

        kfac = KFAC(config)
        state.precond_state = kfac.init(site_shapes(model), device)
        stats = kfac.compute_stats(taps.acts, pert_grads)   # a microbatch
        new_state, grads = kfac.step(state.precond_state, stats, grads, lr)

    `step` leaves its input state as it was (new tensors throughout), so
    the caller can keep the old state on a skipped step. `last_nu` holds
    the last step's kl_clip scale (a 0-d tensor)."""

    def __init__(self, config: KFACConfig):
        self.config = config
        self.last_nu: Optional[torch.Tensor] = None

    def init(self, shapes: Dict[str, Tuple[int, int]],
             device=None) -> KFACState:
        """Zero factors and identity inverses for every site."""
        cfg = self.config
        factors, inverses = {}, {}
        for site, (din, dout) in shapes.items():
            factors[site] = {
                "A": torch.zeros(din + 1, din + 1, dtype=torch.float32,
                                 device=device),
                "G": torch.zeros(dout, dout, dtype=torch.float32,
                                 device=device)}
            inverses[site] = {
                "A": torch.eye(din + 1, dtype=cfg.inverse_dtype,
                               device=device),
                "G": torch.eye(dout, dtype=cfg.inverse_dtype,
                               device=device)}
        return KFACState(factors=factors, inverses=inverses, count=0)

    # -- statistics ---------------------------------------------------------

    def compute_stats(self, acts: Dict[str, torch.Tensor],
                      pert_grads: Dict[str, torch.Tensor]) -> Dict[str, Site]:
        """One microbatch's A and G a site (module docstring)."""
        sdt = self.config.stats_dtype
        out = {}
        for site, a in acts.items():
            g = pert_grads[site]
            a2 = a.reshape(-1, a.shape[-1]).float()
            g2 = g.reshape(-1, g.shape[-1]).float()
            rows = a2.shape[0]
            a_aug = torch.cat([a2, a2.new_ones(rows, 1)], dim=1)
            out[site] = {"A": ((a_aug.T @ a_aug) / rows).to(sdt),
                         "G": ((g2.T @ g2) * rows).to(sdt)}
        return out

    # -- factor EMA and inversion -------------------------------------------

    def _update_factors(self, factors: Dict[str, Site],
                        stats: Dict[str, Site]) -> Dict[str, Site]:
        d = self.config.stat_decay
        return {site: {k: d * f + (1.0 - d) * stats[site][k].to(f.dtype)
                       for k, f in fs.items()}
                for site, fs in factors.items()}

    def _invert(self, factors: Dict[str, Site]) -> Dict[str, Site]:
        sqrt_lam = math.sqrt(self.config.damping)
        out_dtype = self.config.inverse_dtype
        out = {}
        for site, fs in factors.items():
            A, G = fs["A"].float(), fs["G"].float()
            tr_a = torch.trace(A) / A.shape[-1]
            tr_g = torch.trace(G) / G.shape[-1]
            pi = torch.sqrt(tr_a.clamp_min(1e-12) / tr_g.clamp_min(1e-12))
            eye_a = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
            eye_g = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
            out[site] = {
                "A": chol_inverse(A + sqrt_lam * pi * eye_a).to(out_dtype),
                "G": chol_inverse(G + sqrt_lam / pi * eye_g).to(out_dtype)}
        return out

    # -- preconditioning ----------------------------------------------------

    def skipped(self, site: str) -> bool:
        """Whether `site` keeps its first-order gradients."""
        names = (site, jax_tap_path(site))
        return any(tok in n for tok in self.config.skip_layers
                   for n in names)

    def precondition(self, inverses: Dict[str, Site],
                     grads: Dict[str, torch.Tensor],
                     lr: float) -> Dict[str, torch.Tensor]:
        """`grads` with every preconditioned site's weight and bias
        gradient replaced by nu F^-1 g (a new dict; the others as they
        were)."""
        out = dict(grads)
        pre = {}
        sq_sum = None
        for site, inv in inverses.items():
            if self.skipped(site):
                continue
            wg, bg = grads[f"{site}.weight"], grads[f"{site}.bias"]
            a_inv, g_inv = inv["A"].float(), inv["G"].float()
            aug = torch.cat([wg.float().T, bg.float()[None]], dim=0)
            p = a_inv @ aug @ g_inv                  # (in + 1, out)
            pk = p[:-1].T.to(wg.dtype, memory_format=torch.contiguous_format)
            pb = p[-1].to(bg.dtype)
            term = (torch.sum(pk.float() * wg.float())
                    + torch.sum(pb.float() * bg.float()))
            sq_sum = term if sq_sum is None else sq_sum + term
            pre[site] = (pk, pb)
        if not pre:
            self.last_nu = None
            return out
        lr_val = torch.tensor(lr, dtype=torch.float32, device=sq_sum.device)
        nu = torch.clamp(torch.sqrt(
            self.config.kl_clip
            / torch.clamp(lr_val ** 2 * torch.abs(sq_sum), min=1e-30)),
            max=1.0)
        self.last_nu = nu
        for site, (pk, pb) in pre.items():
            out[f"{site}.weight"] = (pk * nu).to(pk.dtype)
            out[f"{site}.bias"] = (pb * nu).to(pb.dtype)
        return out

    # -- one optimization step ----------------------------------------------

    def step(self, state: KFACState, stats: Dict[str, Site],
             grads: Dict[str, torch.Tensor], lr: float
             ) -> Tuple[KFACState, Dict[str, torch.Tensor]]:
        """The factor EMA (on its interval), the inversion (on its), then
        the preconditioned gradients; returns (new state, new grads)."""
        cfg = self.config
        do_factor = state.count % cfg.factor_interval == 0
        if cfg.factor_sync_freq > 1:
            do_factor = do_factor and state.count % cfg.factor_sync_freq == 0
        factors = (self._update_factors(state.factors, stats) if do_factor
                   else state.factors)
        inverses = (self._invert(factors)
                    if state.count % cfg.inv_interval == 0
                    else state.inverses)
        grads = self.precondition(inverses, grads, lr)
        return KFACState(factors=factors, inverses=inverses,
                         count=state.count + 1), grads


def describe(state: KFACState, config: KFACConfig,
             skipped: Iterable[str] = ()) -> str:
    """The run log's line: the sites, the factor and inverse bytes."""
    fb, ib = state.nbytes()
    skipped = list(skipped)
    return (f"kfac: {len(state.factors)} sites ({len(skipped)} skipped by "
            f"{list(config.skip_layers)}), factors {fb / 1e9:.3f} GB "
            f"(torch.float32), inverses {ib / 1e9:.3f} GB "
            f"({config.inverse_dtype}); inv_interval {config.inv_interval},"
            f" factor_interval {config.factor_interval}, stat_decay "
            f"{config.stat_decay}, damping {config.damping}, kl_clip "
            f"{config.kl_clip}")
