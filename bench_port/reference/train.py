"""Plain reference of the segmentation train step: pixel cross-entropy
(ignore index) plus the weighted auxiliary one, the gradient, and AdamW with
decoupled weight decay, at the recipe's poly schedule with linear warmup.
float32, written out, from the configuration file alone.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def pixel_ce(logits: torch.Tensor, labels: torch.Tensor, ignore: int, count: torch.Tensor):
    """Summed negative log-likelihood of the labelled pixels over ``count``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore
    picked = torch.gather(logp, -1, labels.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return -(picked * valid).sum() / count.clamp_min(1)


def seg_loss(out, labels: torch.Tensor, aux_weight: float, ignore: int) -> torch.Tensor:
    logits, aux = out if isinstance(out, tuple) else (out, None)
    count = (labels != ignore).sum()
    loss = pixel_ce(logits, labels, ignore, count)
    if aux is not None:
        loss = loss + aux_weight * pixel_ce(aux, labels, ignore, count)
    return loss


def poly_lr(cfg: dict, step: int) -> float:
    """The learning rate at 0-based ``step`` of the train config ``cfg``."""
    opt, sch = cfg["optimizer"], cfg["schedule"]
    base, warm = opt["lr"], sch["warmup_iters"]
    if sch["policy"] != "poly":
        raise NotImplementedError(sch["policy"])
    if step < warm:
        return base * (sch["warmup_ratio"] + (1.0 - sch["warmup_ratio"]) * step / max(warm, 1))
    frac = min(max((step - warm) / max(sch["max_iters"] - warm, 1), 0.0), 1.0)
    return (base - sch["min_lr"]) * (1.0 - frac) ** sch["power"] + sch["min_lr"]


class AdamW:
    """AdamW: m and v with bias correction, eps added to sqrt(v̂), the decay
    multiplied into the weight before the update. A leaf whose name holds one
    of ``no_decay_keys`` (any case) is not decayed."""

    def __init__(self, named: Dict[str, torch.Tensor], cfg: dict):
        opt = cfg["optimizer"]
        self.b1, self.b2 = opt["betas"]
        keys = [k.lower() for k in opt["no_decay_keys"]]
        self.decay = {n: 0.0 if any(k in n.lower() for k in keys) else opt["weight_decay"]
                      for n in named}
        self.m = {n: torch.zeros_like(p) for n, p in named.items()}
        self.v = {n: torch.zeros_like(p) for n, p in named.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, named: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in named.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.mul_(1.0 - lr * self.decay[n])
            p.sub_(lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + 1e-8))


def leaf_norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.detach().float())) for t in tensors]


def run_steps(model, cfg: dict, batches, start_step: int, mask_seed: int, device) -> dict:
    """``len(batches)`` train steps of the reference ``model`` (float32, in
    training mode) from its weights as they are, its masks drawn from a
    generator seeded ``mask_seed``; the schedule at ``start_step`` + i.

    Returns each step's loss, each leaf's gradient norm at the first step
    and each leaf's change over all the steps (the names of
    ``model.named_parameters()``, in that order)."""
    mc = cfg["model"]
    named = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    opt = AdamW(named, cfg)
    model.ctx.generator = torch.Generator(device=device).manual_seed(mask_seed)
    model.train()
    losses, first_grad = [], None
    for i, (image, label) in enumerate(batches):
        for p in named.values():
            p.grad = None
        loss = seg_loss(model(image), label, mc["aux_loss_weight"],
                        cfg["data"]["ignore_index"])
        loss.backward()
        if first_grad is None:
            first_grad = leaf_norms([p.grad if p.grad is not None else torch.zeros_like(p)
                                     for p in named.values()])
        opt.step(named, poly_lr(cfg, start_step + i))
        losses.append(float(loss.detach()))
    change = leaf_norms([p.detach() - start[n] for n, p in named.items()])
    return {"names": list(named), "losses": losses, "grad": first_grad, "change": change}
