"""SAM2's model (sam2/modeling/sam2_base.py:22-829; the JAX package's
`models/sam2_base.py`): `SAM2Config`, and of `SAM2Base` the image encoder
with the SAM heads' high-resolution projections (`forward_image`), the
prompt encoder and mask decoder with the object pointer
(`forward_sam_heads`), `use_mask_as_output`, and the memory half of the
video tracker: the memory attention over an assembled memory bank
(`condition_features_on_memory`) and the memory encoder
(`encode_new_memory`). As in the JAX package, the model holds only the
device programs; the predictors on the host choose frames and assemble the
bank. The parameters carry the reference's state-dict names, so an
official checkpoint loads strictly, every key included.

NHWC image features; masks (B, M, h, w). The module computes in the dtype
of its parameters (`build_sam2` casts it once); masks leave the heads in
fp32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from sam2unet_torch.configs import HieraConfig
from sam2unet_torch.models.fpn import ImageEncoder
from sam2unet_torch.models.mask_decoder import MaskDecoder
from sam2unet_torch.models.memory import MemoryAttention, MemoryEncoder
from sam2unet_torch.models.prompt_encoder import PromptEncoder
from sam2unet_torch.nn.layers import MLP
from sam2unet_torch.ops.resize import resize_nhwc

NO_OBJ_SCORE = -1024.0


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    """The JAX package's SAM2Config (sam2_hiera_s.yaml:87-116 defaults)."""

    image_size: int = 1024
    backbone_stride: int = 16
    num_maskmem: int = 7
    mem_dim: int = 64
    hidden_dim: int = 256
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    binarize_mask_from_pts_for_mem_enc: bool = False
    use_mask_input_as_output_without_sam: bool = True
    max_cond_frames_in_attn: int = -1
    directly_add_no_mem_embed: bool = True
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    iou_prediction_use_sigmoid: bool = True
    memory_temporal_stride_for_eval: int = 1
    non_overlap_masks_for_mem_enc: bool = False
    use_obj_ptrs_in_encoder: bool = True
    max_obj_ptrs_in_encoder: int = 16
    add_tpos_enc_to_obj_ptrs: bool = False
    proj_tpos_enc_in_obj_ptrs: bool = False
    only_obj_ptrs_in_the_past_for_eval: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    soft_no_obj_ptr: bool = False
    use_mlp_for_obj_ptr_proj: bool = True
    add_all_frames_to_correct_as_cond: bool = False
    dynamic_multimask_via_stability: bool = False
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98


class SAM2Base(nn.Module):
    def __init__(self, trunk_cfg: HieraConfig, cfg: SAM2Config = SAM2Config()):
        super().__init__()
        self.cfg = c = cfg
        self.image_encoder = ImageEncoder(trunk_cfg, d_model=c.hidden_dim,
                                          scalp=1)
        embed = c.image_size // c.backbone_stride
        self.sam_prompt_encoder = PromptEncoder(
            c.hidden_dim, (embed, embed), (c.image_size, c.image_size), 16)
        self.sam_mask_decoder = MaskDecoder(
            c.hidden_dim, num_multimask_outputs=3, iou_head_depth=3,
            iou_head_hidden_dim=256,
            use_high_res_features=c.use_high_res_features_in_sam,
            iou_prediction_use_sigmoid=c.iou_prediction_use_sigmoid,
            dynamic_multimask_via_stability=c.dynamic_multimask_via_stability,
            dynamic_multimask_stability_delta=c.dynamic_multimask_stability_delta,
            dynamic_multimask_stability_thresh=c.dynamic_multimask_stability_thresh,
            pred_obj_scores=c.pred_obj_scores,
            pred_obj_scores_mlp=c.pred_obj_scores_mlp,
            use_multimask_token_for_obj_ptr=c.use_multimask_token_for_obj_ptr)
        self.memory_attention = MemoryAttention(c.hidden_dim, num_layers=4,
                                                kv_in_dim=c.mem_dim)
        self.memory_encoder = MemoryEncoder(c.mem_dim, c.hidden_dim)
        self.maskmem_tpos_enc = nn.Parameter(
            torch.randn(c.num_maskmem, 1, 1, c.mem_dim) * 0.02)
        self.no_mem_embed = nn.Parameter(torch.randn(1, 1, c.hidden_dim) * 0.02)
        self.no_mem_pos_enc = nn.Parameter(
            torch.randn(1, 1, c.hidden_dim) * 0.02)
        # the JAX package creates no_obj_ptr under pred_obj_scores alone
        # (the reference reads it there but creates it only with
        # use_obj_ptrs_in_encoder too, sam2_base.py:169-170 vs :390-399)
        if c.pred_obj_scores:
            self.no_obj_ptr = nn.Parameter(torch.randn(1, c.hidden_dim) * 0.02)
        if c.use_obj_ptrs_in_encoder:
            self.mask_downsample = nn.Conv2d(1, 1, 4, stride=4)
            self.obj_ptr_proj = (
                MLP(c.hidden_dim, c.hidden_dim, c.hidden_dim, 3)
                if c.use_mlp_for_obj_ptr_proj
                else nn.Linear(c.hidden_dim, c.hidden_dim))
        if c.proj_tpos_enc_in_obj_ptrs:
            self.obj_ptr_tpos_proj = nn.Linear(c.hidden_dim, c.mem_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.no_mem_embed.dtype

    def forward_image(self, img: torch.Tensor) -> dict:
        """(sam2_base.py:463-477): img (B, S, S, 3) normalised -> the
        encoder's dict, its two finest levels projected by conv_s0/conv_s1."""
        out = self.image_encoder(img.to(self.dtype))
        if self.cfg.use_high_res_features_in_sam:
            fpn = list(out["backbone_fpn"])
            fpn[0], fpn[1] = self.sam_mask_decoder.project_high_res(fpn[0],
                                                                    fpn[1])
            out["backbone_fpn"] = fpn
        return out

    def _obj_ptr(self, obj_ptr, object_score_logits):
        c = self.cfg
        if c.pred_obj_scores:
            lam = (torch.sigmoid(object_score_logits.float()) if c.soft_no_obj_ptr
                   else (object_score_logits > 0).float())
            if c.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr.float()
        return obj_ptr

    def forward_sam_heads(self, backbone_features, point_coords, point_labels,
                          mask_inputs=None, high_res_features=None,
                          multimask_output: bool = False):
        """(sam2_base.py:251-409): the reference's 7-tuple (low-res
        multimasks, high-res multimasks, ious, low-res masks, high-res
        masks, object pointer, object score logits); masks fp32."""
        c = self.cfg
        b = backbone_features.shape[0]
        pe = self.sam_prompt_encoder
        mask_prompt = None
        if mask_inputs is not None:
            mask_prompt = resize_nhwc(mask_inputs.float(), pe.mask_input_size,
                                      "bilinear", antialias=True)
        sparse, dense = pe(point_coords, point_labels, mask_prompt)
        low_res_multimasks, ious, sam_output_tokens, object_score_logits = (
            self.sam_mask_decoder(backbone_features, pe.get_dense_pe(), sparse,
                                  dense, multimask_output, high_res_features))
        low_res_multimasks = low_res_multimasks.float()
        if c.pred_obj_scores:
            low_res_multimasks = torch.where(
                (object_score_logits > 0)[:, :, None, None], low_res_multimasks,
                NO_OBJ_SCORE)
        hr = resize_nhwc(low_res_multimasks.permute(0, 2, 3, 1),
                         (c.image_size, c.image_size)).permute(0, 3, 1, 2)
        sam_output_token = sam_output_tokens[:, 0]
        if multimask_output:
            best = ious.argmax(dim=-1)
            bidx = torch.arange(b, device=ious.device)
            low_res_masks = low_res_multimasks[bidx, best][:, None]
            high_res_masks = hr[bidx, best][:, None]
            if sam_output_tokens.shape[1] > 1:
                sam_output_token = sam_output_tokens[bidx, best]
        else:
            low_res_masks, high_res_masks = low_res_multimasks, hr
        if c.use_obj_ptrs_in_encoder:
            obj_ptr = self.obj_ptr_proj(sam_output_token).float()
        else:
            obj_ptr = hr.new_zeros(b, c.hidden_dim)
        obj_ptr = self._obj_ptr(obj_ptr, object_score_logits)
        return (low_res_multimasks, hr, ious, low_res_masks, high_res_masks,
                obj_ptr, object_score_logits)

    def use_mask_as_output(self, backbone_features, high_res_features,
                           mask_inputs):
        """(sam2_base.py:411-462): the input mask (B, S, S, 1) taken as the
        output, its object pointer from the SAM heads on the downsampled
        mask."""
        c = self.cfg
        out_scale, out_bias = 20.0, -10.0
        mif = mask_inputs.float()
        high_res = mif * out_scale + out_bias
        low_res = resize_nhwc(high_res, (high_res.shape[1] // 4,
                                         high_res.shape[2] // 4),
                              "bilinear", antialias=True)
        b = mask_inputs.shape[0]
        ious = mif.new_ones(b, 1)
        if not c.use_obj_ptrs_in_encoder:
            obj_ptr = mif.new_zeros(b, c.hidden_dim)
        else:
            ds = self.mask_downsample(mif.permute(0, 3, 1, 2).to(self.dtype))
            obj_ptr = self.forward_sam_heads(
                backbone_features, mif.new_zeros(b, 1, 2),
                -torch.ones(b, 1, dtype=torch.int32, device=mif.device),
                mask_inputs=ds.permute(0, 2, 3, 1),
                high_res_features=high_res_features)[5]
        lam = (mif.reshape(b, -1) > 0).any(dim=1, keepdim=True).float()
        object_score_logits = out_scale * lam + out_bias
        if c.pred_obj_scores:
            if c.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr.float()
        lr, hr = low_res.permute(0, 3, 1, 2), high_res.permute(0, 3, 1, 2)
        return lr, hr, ious, lr, hr, obj_ptr, object_score_logits

    # ------------------------------------------------------------- memory

    def condition_features_on_memory(self, current_feat, current_pos, memory,
                                     memory_pos, num_obj_ptr_tokens: int = 0,
                                     is_init_cond_frame: bool = False,
                                     memory_valid=None) -> torch.Tensor:
        """The device half of _prepare_memory_conditioned_features
        (sam2_base.py:493-662): current_feat and current_pos (B, H, W, C),
        the assembled bank memory / memory_pos (B, S_mem, mem_dim) with its
        last `num_obj_ptr_tokens` the object pointers, `memory_valid`
        (B, S_mem) bool marking the real tokens of a padded bank. Returns
        the conditioned (B, H, W, C) features."""
        c = self.cfg
        b, h, w, ch = current_feat.shape
        if c.num_maskmem == 0:
            return current_feat
        feats = current_feat.reshape(b, h * w, ch)
        if is_init_cond_frame:
            if c.directly_add_no_mem_embed:
                return (feats + self.no_mem_embed).reshape(b, h, w, ch)
            # mem_dim-wide memory tokens (the JAX package's slice, where the
            # reference's expand works only with mem_dim == hidden_dim)
            memory = self.no_mem_embed[:, :, :c.mem_dim].expand(b, 1, c.mem_dim)
            memory_pos = self.no_mem_pos_enc[:, :, :c.mem_dim].expand(
                b, 1, c.mem_dim)
            num_obj_ptr_tokens, memory_valid = 0, None
        out = self.memory_attention(
            feats, memory, current_pos.reshape(b, h * w, ch), memory_pos,
            num_obj_ptr_tokens, memory_valid)
        return out.reshape(b, h, w, ch)

    def encode_new_memory(self, current_feat, pred_masks_high_res,
                          is_mask_from_pts: bool = False):
        """(sam2_base.py:664-702): current_feat (B, H, W, C), the high-res
        mask logits (B, 1, S, S) -> (memory features (B, H, W, mem_dim),
        [their (1, H, W, mem_dim) sine encoding]). A mask from points is
        binarised where the config asks, else squashed by the sigmoid."""
        c = self.cfg
        masks = pred_masks_high_res.float().permute(0, 2, 3, 1)
        if c.non_overlap_masks_for_mem_enc:
            masks = self.apply_non_overlapping_constraints(masks)
        if c.binarize_mask_from_pts_for_mem_enc and is_mask_from_pts:
            mask_for_mem = (masks > 0).float()
        else:
            mask_for_mem = torch.sigmoid(masks)
        mask_for_mem = (mask_for_mem * c.sigmoid_scale_for_mem_enc
                        + c.sigmoid_bias_for_mem_enc)
        out = self.memory_encoder(current_feat, mask_for_mem,
                                  skip_mask_sigmoid=True)
        return out["vision_features"], out["vision_pos_enc"]

    @staticmethod
    def apply_non_overlapping_constraints(pred_masks: torch.Tensor
                                          ) -> torch.Tensor:
        """(sam2_base.py:812-829): objects along dim 0; each pixel keeps its
        score in the object of the highest one, the others are clamped to
        at most -10."""
        if pred_masks.shape[0] == 1:
            return pred_masks
        best = pred_masks.argmax(dim=0, keepdim=True)
        idx = torch.arange(pred_masks.shape[0], device=pred_masks.device)
        keep = best == idx.reshape(-1, *[1] * (pred_masks.dim() - 1))
        return torch.where(keep, pred_masks, pred_masks.clamp(max=-10.0))

    def use_multimask(self, is_init_cond_frame: bool, num_pts: int) -> bool:
        """(sam2_base.py:791-799), decided on the host."""
        c = self.cfg
        return (c.multimask_output_in_sam
                and (is_init_cond_frame or c.multimask_output_for_tracking)
                and c.multimask_min_pt_num <= num_pts <= c.multimask_max_pt_num)
