"""Train state (counterpart of bert_pytorch_tpu/training/state.py,
trimmed): the global step, the f32 master parameters and the optimizer
state (LAMB's or FusedAdam's: a count and one mu and one nu per name).

`params` are the model's own parameter tensors (detached views of them),
so the model and the state always hold the same weights; the step updates
them in place, and `load_state_dict` copies a checkpoint into them.

`state_dict()` is what a checkpoint carries: {"step", "params" by name,
"opt_state": {"count", "mu" by name, "nu" by name}}, and with K-FAC on
(`precond_state`, optim/kfac.KFACState) "precond_state": {"count",
"factors" and "inverses" by "<site>/<A|G>"}. `telemetry`, the
health pack's carry (telemetry/health.TelemetryState), is attached after
a restore and never saved, so a checkpoint's structure is the same with
the pack on or off. Under a sharded state (`sharding`: ZeRO-1, fsdp or
the model axis) the moments are the rank's pieces, the masters its model
part (or its slice of it), and both methods are collective and speak the
one-card format, so a checkpoint moves between mesh shapes
(parallel/zero.py). Both
LAMB routes
and FusedAdam keep that layout, so a state saved under one LAMB route
resumes under the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from bert_pytorch_tpu_torch.optim.adam import AdamState
from bert_pytorch_tpu_torch.optim.lamb import LambState


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Union[LambState, AdamState]
    telemetry: Optional[Any] = None
    precond_state: Optional[Any] = None
    # ZeRO-1 (parallel/zero.DataParallel): the moments hold this rank's
    # pieces; state_dict() and load_state_dict() speak the one-card format
    sharding: Optional[Any] = None

    def state_dict(self) -> Dict:
        if self.sharding is not None:
            return self.sharding.full_state_dict(self)
        sd = {"step": int(self.step), "params": dict(self.params),
              "opt_state": {"count": int(self.opt_state.count),
                            "mu": dict(self.opt_state.mu),
                            "nu": dict(self.opt_state.nu)}}
        if self.precond_state is not None:
            sd["precond_state"] = self.precond_state.state_dict()
        return sd

    def load_state_dict(self, sd: Dict) -> None:
        """Copy a state_dict() in place: every tensor by name, of the same
        shape (a missing, extra or reshaped entry raises before anything
        is copied), then the step and the optimizer's count; with K-FAC on,
        the factors and inverses the same way (a checkpoint without them,
        or with them where K-FAC is off, raises)."""
        if self.sharding is not None:
            return self.sharding.load_full_state_dict(self, sd)
        opt = sd["opt_state"]
        groups = [("params", self.params, sd["params"]),
                  ("mu", self.opt_state.mu, opt["mu"]),
                  ("nu", self.opt_state.nu, opt["nu"])]
        pre = sd.get("precond_state")
        if (pre is None) != (self.precond_state is None):
            raise ValueError(
                "checkpoint " + ("has no" if pre is None else "has a")
                + " K-FAC precond_state and this run has K-FAC "
                + ("on" if pre is None else "off"))
        if pre is not None:
            mine = self.precond_state.state_dict()
            groups += [("kfac factors", mine["factors"], pre["factors"]),
                       ("kfac inverses", mine["inverses"], pre["inverses"])]
        pairs = []
        for what, have, got in groups:
            if set(have) != set(got):
                missing = sorted(set(have) - set(got))
                extra = sorted(set(got) - set(have))
                raise ValueError(f"checkpoint {what} do not match the "
                                 f"model: missing {missing[:5]}, unexpected "
                                 f"{extra[:5]}")
            for k, t in have.items():
                if tuple(got[k].shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint {what} {k}: shape "
                                     f"{tuple(got[k].shape)}, model "
                                     f"{tuple(t.shape)}")
                pairs.append((t, got[k]))
        with torch.no_grad():
            for t, src in pairs:
                t.copy_(src)
        self.step = int(sd["step"])
        self.opt_state.count = int(opt["count"])
        if pre is not None:
            self.precond_state.count = int(pre["count"])


def make_train_state(model: nn.Module, tx,
                     extra: Optional[Dict[str, torch.Tensor]] = None,
                     dp=None) -> TrainState:
    """A fresh state over `model`'s parameters, which must be f32, and
    `extra`, parameters by name trained beside them (a distillation run's
    projections); `tx` is a Lamb or a FusedAdam. `dp`, a sharded
    parallel/zero.DataParallel built over `model`, gives LAMB moments for
    this rank's pieces alone, and `state_dict()` becomes collective."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    for k, p in (extra or {}).items():
        if k in params:
            raise ValueError(f"extra parameter {k!r} shadows the model's")
        params[k] = p.detach()
    bad = [k for k, p in params.items() if p.dtype != torch.float32]
    if bad:
        raise ValueError(f"master parameters must be float32: {bad[:3]}")
    if dp is not None and dp.sharded:
        if extra:
            raise ValueError("a sharded state takes the model's parameters "
                             "alone")
        mu, nu = dp.init_moments()
        return TrainState(step=0, params=params,
                          opt_state=LambState(count=0, mu=mu, nu=nu),
                          sharding=dp)
    return TrainState(step=0, params=params, opt_state=tx.init(params))
