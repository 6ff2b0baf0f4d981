"""OHEM-masked multi-task L2 loss (port of ``densebox_tpu/ops/ohem.py``;
paper §3.3).

  L = mean_sampled (s^ - y)^2  +  lambda_loc * mean_pos sum_4 (d^ - d*)^2
      [+ lambda_lm * balanced-L2(landmark heatmaps)
       + lambda_refine * OHEM-L2(refined)]

OHEM mask: keep all positives; sample #neg = neg_pos_ratio * #pos negatives
(min_neg for patches without positives), hard_frac of them the highest-loss
negatives, the rest at random from the remaining candidates; gray-zone
pixels are never sampled. Both classification terms (raw and refined score)
mine their own hard negatives. Per-term normalisation is by the sampled
count (cls) and the positive count (loc); the landmark term is
class-balanced L2 (half the mean over positives, half over negatives).

The selection is ``ops/kernels/ohem.py:ohem_select`` (the CUDA kernel on
the card, its plain version on the CPU). Its uniform noise is an argument
here: the caller draws one (B, P) tensor per classification term. Each
term launches the selection on its own: stacking the two terms of a
landmark step into one (2B, P) launch was timed on an H100 and saves about
2 us of device time for about 30 us more on the host (the copies that stack
them).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from densebox_tpu_torch.config import LossCfg
from densebox_tpu_torch.ops.kernels.ohem import ohem_select


def ohem_mask(sq_loss: torch.Tensor, pos: torch.Tensor, ignore: torch.Tensor,
              rnd: torch.Tensor, cfg: LossCfg) -> torch.Tensor:
    """OHEM sampling mask of one sample: (P,) squared errors, bool
    positives and gray zone, uniforms -> (P,) bool."""
    return ohem_select(sq_loss[None], pos[None], ignore[None], rnd[None],
                       cfg.neg_pos_ratio, cfg.hard_frac, cfg.min_neg)[0]


def _cls_mask(pred: torch.Tensor, gt: torch.Tensor, ignore: torch.Tensor,
              rnd: torch.Tensor, cfg: LossCfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The squared errors (B, M*M) of a classification term and its OHEM
    mask (B, M*M) bool; pred, gt and ignore (B, M, M, 1), rnd (B, M*M). The
    mask is a constant of the graph: it selects, and carries no gradient.

    The selection is per sample: a sample's negative quota comes from its
    own positives (or ``min_neg``) and its own uniforms, so the rows of a
    data-parallel rank select exactly what the same rows of the global
    batch select. Only the normalisers below are batch-wide."""
    b = pred.shape[0]
    sq = ((pred - gt) ** 2).reshape(b, -1)
    pos = (gt > 0.5).reshape(b, -1)
    ign = (ignore > 0.5).reshape(b, -1)
    with torch.no_grad():
        mask = ohem_select(sq.detach().contiguous(), pos, ign, rnd,
                           cfg.neg_pos_ratio, cfg.hard_frac, cfg.min_neg)
    return sq, mask


def densebox_loss(
    outputs: Dict[str, torch.Tensor],   # model heads (score/loc[/lm/refined])
    gts: Dict[str, torch.Tensor],       # rasterizer maps
    rnd_cls: torch.Tensor,              # (B, M*M) uniforms for the score term
    cfg: LossCfg,
    rnd_refined: Optional[torch.Tensor] = None,   # same, for the refined term
    total: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total multi-task loss and a dict of scalar float32 metrics.

    Each term is a sum over the batch divided by a count over the batch
    (sampled pixels, positives, landmark positives and negatives).
    ``total`` maps the float64 vector of this batch's counts to the counts
    of the global batch (a data-parallel step sums them over its ranks);
    the loss is then this batch's share of the global loss, the shares of
    the ranks add up to it, and so do their gradients. ``n_pos`` and
    ``n_sampled`` are the global counts. Without ``total`` the batch is the
    global batch."""
    for name in ("score", "loc"):
        if outputs[name].shape != gts[name].shape:
            raise ValueError(f"densebox_loss: {name} prediction "
                             f"{tuple(outputs[name].shape)} against target "
                             f"{tuple(gts[name].shape)}")
    if outputs["score"].dim() != 4:
        raise ValueError("densebox_loss: want (B, M, M, C) maps")
    has_lm = "lm" in outputs and "lm" in gts
    if has_lm and outputs["lm"].shape != gts["lm"].shape:
        raise ValueError(f"densebox_loss: lm prediction "
                         f"{tuple(outputs['lm'].shape)} against target "
                         f"{tuple(gts['lm'].shape)}")
    if "refined" in outputs and rnd_refined is None:
        raise ValueError("densebox_loss: the model has a refined score; "
                         "its OHEM term needs rnd_refined")

    sq, mask = _cls_mask(outputs["score"], gts["score"], gts["ignore"],
                         rnd_cls, cfg)
    loc_mask = gts["loc_mask"]
    counts = [mask.sum(), loc_mask.sum(), gts["score"].sum()]
    if has_lm:
        lm_pos = gts["lm"] > 0.5
        counts += [lm_pos.sum(), (~lm_pos).sum()]
    if "refined" in outputs:
        ref_sq, ref_mask = _cls_mask(outputs["refined"], gts["score"],
                                     gts["ignore"], rnd_refined, cfg)
        counts.append(ref_mask.sum())
    # integer-valued counts: exact in float64, and in float32 below 2**24
    counts = torch.stack([c.double() for c in counts])
    if total is not None:
        counts = total(counts)
    counts = counts.float()

    cls_loss = (sq * mask).sum() / counts[0].clamp(min=1.0)
    loc_sq = ((outputs["loc"] - gts["loc"]) ** 2).sum(dim=-1, keepdim=True)
    loc_loss = (loc_sq * loc_mask).sum() / counts[1].clamp(min=1.0)

    total_loss = cls_loss + cfg.lambda_loc * loc_loss
    metrics = {
        "loss_cls": cls_loss,
        "loss_loc": loc_loss,
        "n_pos": counts[2],
        "n_sampled": counts[0],
    }

    if has_lm:
        lm_sq = (outputs["lm"] - gts["lm"]) ** 2
        lm_loss = 0.5 * ((lm_sq * lm_pos).sum() / counts[3].clamp(min=1.0)
                         + (lm_sq * ~lm_pos).sum() / counts[4].clamp(min=1.0))
        total_loss = total_loss + cfg.lambda_lm * lm_loss
        metrics["loss_lm"] = lm_loss

    if "refined" in outputs:
        ref_loss = (ref_sq * ref_mask).sum() / counts[-1].clamp(min=1.0)
        total_loss = total_loss + cfg.lambda_refine * ref_loss
        metrics["loss_refined"] = ref_loss

    metrics["loss_total"] = total_loss
    return total_loss, {k: v.detach() for k, v in metrics.items()}
