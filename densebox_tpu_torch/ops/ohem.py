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
here: the caller draws one (B, P) tensor per classification term.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from densebox_tpu_torch.config import LossCfg
from densebox_tpu_torch.ops.kernels.ohem import ohem_select


def ohem_mask(sq_loss: torch.Tensor, pos: torch.Tensor, ignore: torch.Tensor,
              rnd: torch.Tensor, cfg: LossCfg) -> torch.Tensor:
    """OHEM sampling mask of one sample: (P,) squared errors, bool
    positives and gray zone, uniforms -> (P,) bool."""
    return ohem_select(sq_loss[None], pos[None], ignore[None], rnd[None],
                       cfg.neg_pos_ratio, cfg.hard_frac, cfg.min_neg)[0]


def _cls_term(pred: torch.Tensor, gt: torch.Tensor, ignore: torch.Tensor,
              rnd: torch.Tensor, cfg: LossCfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OHEM-masked L2 classification term over a batch; pred, gt and ignore
    (B, M, M, 1), rnd (B, M*M). Returns (loss, (B, M*M) bool mask). The mask
    is a constant of the graph: it selects, and carries no gradient."""
    b = pred.shape[0]
    sq = ((pred - gt) ** 2).reshape(b, -1)
    pos = (gt > 0.5).reshape(b, -1)
    ign = (ignore > 0.5).reshape(b, -1)
    with torch.no_grad():
        mask = ohem_select(sq.detach().contiguous(), pos, ign, rnd,
                           cfg.neg_pos_ratio, cfg.hard_frac, cfg.min_neg)
    n = mask.sum().clamp(min=1)
    return (sq * mask).sum() / n, mask


def densebox_loss(
    outputs: Dict[str, torch.Tensor],   # model heads (score/loc[/lm/refined])
    gts: Dict[str, torch.Tensor],       # rasterizer maps
    rnd_cls: torch.Tensor,              # (B, M*M) uniforms for the score term
    cfg: LossCfg,
    rnd_refined: Optional[torch.Tensor] = None,   # same, for the refined term
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total multi-task loss and a dict of scalar float32 metrics."""
    for name in ("score", "loc"):
        if outputs[name].shape != gts[name].shape:
            raise ValueError(f"densebox_loss: {name} prediction "
                             f"{tuple(outputs[name].shape)} against target "
                             f"{tuple(gts[name].shape)}")
    if outputs["score"].dim() != 4:
        raise ValueError("densebox_loss: want (B, M, M, C) maps")

    cls_loss, mask = _cls_term(outputs["score"], gts["score"], gts["ignore"],
                               rnd_cls, cfg)
    loc_mask = gts["loc_mask"]
    npos = loc_mask.sum().clamp(min=1.0)
    loc_sq = ((outputs["loc"] - gts["loc"]) ** 2).sum(dim=-1, keepdim=True)
    loc_loss = (loc_sq * loc_mask).sum() / npos

    total = cls_loss + cfg.lambda_loc * loc_loss
    metrics = {
        "loss_cls": cls_loss,
        "loss_loc": loc_loss,
        "n_pos": gts["score"].sum(),
        "n_sampled": mask.sum().float(),
    }

    if "lm" in outputs and "lm" in gts:
        if outputs["lm"].shape != gts["lm"].shape:
            raise ValueError(f"densebox_loss: lm prediction "
                             f"{tuple(outputs['lm'].shape)} against target "
                             f"{tuple(gts['lm'].shape)}")
        lm_sq = (outputs["lm"] - gts["lm"]) ** 2
        lm_pos = gts["lm"] > 0.5
        p = lm_pos.sum().float().clamp(min=1.0)
        n = (~lm_pos).sum().float().clamp(min=1.0)
        lm_loss = 0.5 * ((lm_sq * lm_pos).sum() / p
                         + (lm_sq * ~lm_pos).sum() / n)
        total = total + cfg.lambda_lm * lm_loss
        metrics["loss_lm"] = lm_loss

    if "refined" in outputs:
        if rnd_refined is None:
            raise ValueError("densebox_loss: the model has a refined score; "
                             "its OHEM term needs rnd_refined")
        ref_loss, _ = _cls_term(outputs["refined"], gts["score"],
                                gts["ignore"], rnd_refined, cfg)
        total = total + cfg.lambda_refine * ref_loss
        metrics["loss_refined"] = ref_loss

    metrics["loss_total"] = total
    return total, {k: v.detach() for k, v in metrics.items()}
