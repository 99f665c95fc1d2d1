"""SAM mask decoder (sam2/modeling/sam/mask_decoder.py:15-295; the JAX
package's `models/mask_decoder.py`): the object-score, IoU and mask tokens
through the two-way transformer, the upscaling with the high-resolution
features (`conv_s0`/`conv_s1`), hypernetwork masks, and the
stability-based choice between the single mask and the best of the
multimask outputs. Image features NHWC; masks (B, M, 4H, 4W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sam2unet_torch.models.transformer import TwoWayTransformer
from sam2unet_torch.nn.layers import MLP, LayerNorm2d, gelu


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int, transformer_depth: int = 2,
                 transformer_mlp_dim: int = 2048, transformer_num_heads: int = 8,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256,
                 use_high_res_features: bool = False,
                 iou_prediction_use_sigmoid: bool = False,
                 dynamic_multimask_via_stability: bool = False,
                 dynamic_multimask_stability_delta: float = 0.05,
                 dynamic_multimask_stability_thresh: float = 0.98,
                 pred_obj_scores: bool = False,
                 pred_obj_scores_mlp: bool = False,
                 use_multimask_token_for_obj_ptr: bool = False):
        super().__init__()
        d = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(
            transformer_depth, d, transformer_num_heads, transformer_mlp_dim)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.pred_obj_scores = pred_obj_scores
        if pred_obj_scores:
            self.obj_score_token = nn.Embedding(1, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4),
            nn.GELU(), nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2),
            nn.GELU())
        self.use_high_res_features = use_high_res_features
        if use_high_res_features:
            self.conv_s0 = nn.Conv2d(d, d // 8, 1)
            self.conv_s1 = nn.Conv2d(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(
            d, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth,
            sigmoid_output=iou_prediction_use_sigmoid)
        if pred_obj_scores:
            self.pred_obj_score_head = (MLP(d, d, 1, 3) if pred_obj_scores_mlp
                                        else nn.Linear(d, 1))
        self.dynamic_multimask_via_stability = dynamic_multimask_via_stability
        self.stability_delta = dynamic_multimask_stability_delta
        self.stability_thresh = dynamic_multimask_stability_thresh
        self.use_multimask_token_for_obj_ptr = use_multimask_token_for_obj_ptr

    def project_high_res(self, feat_s0: torch.Tensor, feat_s1: torch.Tensor):
        """The 1x1 projections of the two finest FPN levels (NHWC), which
        the image path applies once per image (sam2_base.py:466-474)."""
        return (F.linear(feat_s0, self.conv_s0.weight.flatten(1),
                         self.conv_s0.bias),
                F.linear(feat_s1, self.conv_s1.weight.flatten(1),
                         self.conv_s1.bias))

    def predict_masks(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                      dense_prompt_embeddings, high_res_features=None):
        toks = [self.iou_token.weight, self.mask_tokens.weight]
        if self.pred_obj_scores:
            toks.insert(0, self.obj_score_token.weight)
        b = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat(toks, dim=0)[None].expand(b, -1, -1)
        tokens = torch.cat([output_tokens.to(sparse_prompt_embeddings.dtype),
                            sparse_prompt_embeddings], dim=1)
        src = image_embeddings + dense_prompt_embeddings
        pos = image_pe.to(src.dtype).expand(src.shape)
        hs, src_out = self.transformer(src, pos, tokens)
        s = 1 if self.pred_obj_scores else 0
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens]

        bb, h, w, c = src.shape
        up = src_out.reshape(bb, h, w, c).permute(0, 3, 1, 2)
        conv1, ln, _, conv2, _ = self.output_upscaling
        if self.use_high_res_features:
            feat_s0, feat_s1 = (f.permute(0, 3, 1, 2) for f in high_res_features)
            up = gelu(ln(conv1(up) + feat_s1))
            up = gelu(conv2(up) + feat_s0)
        else:
            up = gelu(conv2(gelu(ln(conv1(up)))))
        hyper = torch.stack([m(mask_tokens_out[:, i]) for i, m in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("btc,bchw->bthw", hyper, up)
        iou_pred = self.iou_prediction_head(iou_token_out)
        if self.pred_obj_scores:
            object_score_logits = self.pred_obj_score_head(hs[:, 0])
        else:
            object_score_logits = hs.new_full((bb, 1), 10.0)
        return masks, iou_pred, mask_tokens_out, object_score_logits

    def _stability_scores(self, mask_logits: torch.Tensor) -> torch.Tensor:
        flat = mask_logits.flatten(-2)
        d = self.stability_delta
        inter = (flat > d).sum(-1).float()
        union = (flat > -d).sum(-1).float()
        return torch.where(union > 0, inter / union.clamp_min(1), 1.0)

    def _dynamic_multimask(self, all_masks, all_ious):
        """(mask_decoder.py:259-295): the single-mask output where it is
        stable, else the multimask output of the highest IoU."""
        multi_logits, multi_iou = all_masks[:, 1:], all_ious[:, 1:]
        best = multi_iou.argmax(dim=-1)
        bidx = torch.arange(all_masks.shape[0], device=all_masks.device)
        best_logits = multi_logits[bidx, best][:, None]
        best_iou = multi_iou[bidx, best][:, None]
        single_logits, single_iou = all_masks[:, 0:1], all_ious[:, 0:1]
        stable = (self._stability_scores(single_logits)
                  >= self.stability_thresh)
        masks = torch.where(stable[..., None, None], single_logits, best_logits)
        ious = torch.where(stable, single_iou, best_iou)
        return masks, ious

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool,
                high_res_features=None):
        """(masks (B, M, 4H, 4W), iou (B, M), SAM output tokens, object
        score logits (B, 1))."""
        masks, iou_pred, mask_tokens_out, object_score_logits = (
            self.predict_masks(image_embeddings, image_pe,
                               sparse_prompt_embeddings,
                               dense_prompt_embeddings, high_res_features))
        if multimask_output:
            masks, iou_pred = masks[:, 1:], iou_pred[:, 1:]
        elif self.dynamic_multimask_via_stability and not self.training:
            masks, iou_pred = self._dynamic_multimask(masks, iou_pred)
        else:
            masks, iou_pred = masks[:, 0:1], iou_pred[:, 0:1]
        if multimask_output and self.use_multimask_token_for_obj_ptr:
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return masks, iou_pred, sam_tokens_out, object_score_logits
