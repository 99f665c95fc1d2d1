"""The video tracker's memory bank on the card (the port's copy of the JAX
package's `predictors/video_device.py`; sam2/sam2_video_predictor.py:
761-825, 801-813).

The reference keeps the memory bank as a dict of tensors and assembles the
conditioning stack anew every frame. Here it lives in tensors of fixed
shape on the card: the conditioning frames' memories and pointers, made
once per propagation pass, and two rings (mask-memory grids, object
pointers) that the step of each tracked frame writes in place
(`index_copy_`). Per frame the host computes a few int32 gather indices
and validity bits (functions of the frame number and of its mirror of the
rings) and copies one uint8 frame to the card.

What makes it equal to the host-gathered bank
(`video_predictor.py::_gather_memory`):
  - memory tokens are whole grids, so the axial RoPE, repeated per grid,
    does not depend on their order;
  - the object pointers carry no RoPE and each has its own time encoding,
    so their order is free too;
  - slots without a memory are masked out of the cross-attention's softmax
    by `memory_valid`, as the pad of the host path is.
"""

from __future__ import annotations

import numpy as np
import torch

from sam2unet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from sam2unet_torch.models.position_encoding import get_1d_sine_pe
from sam2unet_torch.models.sam2_base import SAM2Base
from sam2unet_torch.ops.connected_components import label_components_torch
from sam2unet_torch.ops.resize import resize_nhwc
from sam2unet_torch.predictors.video_predictor import (
    memory_frame,
    select_closest_cond_frames,
    to_numpy,
)


def _on(x, device, dtype) -> torch.Tensor:
    """A tensor or array on `device` in `dtype`."""
    if torch.is_tensor(x):
        return x.to(device, dtype)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device, dtype)


class DeviceMemoryBank:
    """The bank's tensors on the card and their host mirrors for one
    propagation pass. The grid ring holds (num_maskmem - 2) * r + 2 slots
    keyed on frame % capacity: at frame f the oldest memory the stride
    rule picks is f -+ (1 + (num_maskmem - 2) * r), so no two live frames
    share a slot."""

    def __init__(self, predictor, state, output_dict, batch_size: int):
        cfg = self.cfg = predictor.cfg
        self.device = dev = predictor.device
        dtype = predictor.model.dtype
        r = cfg.memory_temporal_stride_for_eval
        self.grid_cap = max((cfg.num_maskmem - 2) * r + 2, 1)
        self.ptr_cap = max(cfg.max_obj_ptrs_in_encoder, 1)
        cond = output_dict["cond_frame_outputs"]
        self.cond_frames = sorted(cond)
        if not self.cond_frames:
            raise RuntimeError("the device bank needs a conditioning frame")
        b, h, w, c = cond[self.cond_frames[0]]["maskmem_features"].shape
        if b != batch_size:
            raise ValueError(f"conditioning memory of {b} objects, {batch_size}"
                             " tracked")
        self.hw, self.mem_dim = h * w, c
        self.cond_mem = torch.stack([
            _on(cond[t]["maskmem_features"], dev, dtype).reshape(b, h * w, c)
            for t in self.cond_frames])
        self.cond_ptr = torch.stack([_on(cond[t]["obj_ptr"], dev, torch.float32)
                                     for t in self.cond_frames])
        penc = to_numpy(cond[self.cond_frames[0]]["maskmem_pos_enc"][-1])
        self.spatial_penc = _on(penc.reshape(h * w, c), dev, torch.float32)
        # the host path's format, stored with the device path's outputs
        self.penc_list = [penc.reshape(1, h, w, c)]
        self.grid_ring = torch.zeros(self.grid_cap, b, h * w, c, dtype=dtype,
                                     device=dev)
        self.ptr_ring = torch.zeros(self.ptr_cap, b, cfg.hidden_dim,
                                    device=dev)
        self.grid_frames = [-1] * self.grid_cap   # frame held by each slot
        self.ptr_frames = [-1] * self.ptr_cap

    def _write(self, ring: torch.Tensor, slot: int, value) -> None:
        ring.index_copy_(0, torch.tensor([slot], device=self.device),
                         _on(value, self.device, ring.dtype).reshape(
                             1, *ring.shape[1:]))

    def _grid_pool_idx(self, frame_idx: int, output_dict, unselected_cond):
        """Index in the pool (conditioning slots, then the ring) of
        frame_idx's mask memory, copied into the ring from output_dict
        when a frame tracked before this pass has it; -1 where none."""
        out = output_dict["non_cond_frame_outputs"].get(frame_idx)
        if out is not None and out.get("maskmem_features") is not None:
            slot = frame_idx % self.grid_cap
            if self.grid_frames[slot] != frame_idx:
                self._write(self.grid_ring, slot, out["maskmem_features"])
                self.grid_frames[slot] = frame_idx
            return len(self.cond_frames) + slot
        if frame_idx in unselected_cond:
            return self.cond_frames.index(frame_idx)
        return -1

    def _ptr_pool_idx(self, frame_idx: int, output_dict, unselected_cond):
        out = output_dict["non_cond_frame_outputs"].get(
            frame_idx, unselected_cond.get(frame_idx))
        if out is None:
            return -1
        if frame_idx in self.cond_frames:
            return self.cond_frames.index(frame_idx)
        slot = frame_idx % self.ptr_cap
        if self.ptr_frames[slot] != frame_idx:
            self._write(self.ptr_ring, slot, out["obj_ptr"])
            self.ptr_frames[slot] = frame_idx
        return len(self.cond_frames) + slot

    def gather_meta(self, state, output_dict, frame_idx: int,
                    reverse: bool) -> dict:
        """The host half of the memory selection: the frames
        `_gather_memory` would choose, as pool indices and validity bits."""
        cfg = self.cfg
        n_cond = len(self.cond_frames)
        selected_cond, unselected_cond = select_closest_cond_frames(
            frame_idx, output_dict["cond_frame_outputs"],
            cfg.max_cond_frames_in_attn)
        n_grid = n_cond + cfg.num_maskmem - 1
        g_idx = np.zeros(n_grid, np.int64)
        g_tpos = np.zeros(n_grid, np.int64)
        g_valid = np.zeros(n_grid, bool)
        for i, t in enumerate(self.cond_frames):   # t_pos 0
            g_idx[i], g_tpos[i] = i, cfg.num_maskmem - 1
            g_valid[i] = t in selected_cond
        r = cfg.memory_temporal_stride_for_eval
        for t_pos in range(1, cfg.num_maskmem):
            prev = memory_frame(frame_idx, t_pos, cfg.num_maskmem, r, reverse)
            slot = n_cond + t_pos - 1
            pool = self._grid_pool_idx(prev, output_dict, unselected_cond)
            g_idx[slot], g_tpos[slot] = max(pool, 0), cfg.num_maskmem - t_pos - 1
            g_valid[slot] = pool >= 0
        meta = {"g_idx": g_idx, "g_tpos": g_tpos, "g_valid": g_valid,
                "store_slot": frame_idx % self.grid_cap,
                "ptr_store_slot": frame_idx % self.ptr_cap}
        if cfg.use_obj_ptrs_in_encoder:
            max_ptrs = min(state["num_frames"], cfg.max_obj_ptrs_in_encoder)
            # every selected conditioning pointer and up to max - 1 others,
            # the host path's pad target
            n_ptr = n_cond + cfg.max_obj_ptrs_in_encoder - 1
            p_idx = np.zeros(n_ptr, np.int64)
            p_tdiff = np.zeros(n_ptr, np.float32)
            p_valid = np.zeros(n_ptr, bool)
            k = 0
            ptr_cond = [t for t in selected_cond
                        if not cfg.only_obj_ptrs_in_the_past_for_eval
                        or (t >= frame_idx if reverse else t <= frame_idx)]
            for t in ptr_cond:
                p_idx[k], p_tdiff[k], p_valid[k] = (
                    self.cond_frames.index(t), abs(frame_idx - t), True)
                k += 1
            for t_diff in range(1, max_ptrs):
                t = frame_idx + t_diff if reverse else frame_idx - t_diff
                if t < 0 or t >= state["num_frames"]:
                    break
                pool = self._ptr_pool_idx(t, output_dict, unselected_cond)
                if pool >= 0:
                    p_idx[k], p_tdiff[k], p_valid[k] = pool, t_diff, True
                    k += 1
            meta.update(p_idx=p_idx, p_tdiff=p_tdiff, p_valid=p_valid,
                        t_diff_max=float(max(max_ptrs - 1, 1)))
        return meta

    def note_tracked(self, frame_idx: int) -> None:
        """Mirror the step's ring writes."""
        self.grid_frames[frame_idx % self.grid_cap] = frame_idx
        self.ptr_frames[frame_idx % self.ptr_cap] = frame_idx


def pack_bits_width(m: torch.Tensor) -> torch.Tensor:
    """A bool tensor packed along its last axis into uint8, most significant
    bit first (np.packbits' layout)."""
    pad = (-m.shape[-1]) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                        device=m.device)
    u = m.reshape(*m.shape[:-1], -1, 8).to(torch.uint8)
    return (u * bits).sum(-1, dtype=torch.uint8)


def build_device_track_step(predictor):
    """The step of one tracked frame on the card: the uint8 frame in, the
    SAM2Transforms preprocess there (antialiased resize, ImageNet
    normalisation), the image encoder, the memory attention over the bank,
    the SAM heads, the memory encoder, the rings written in place, holes
    filled, masks at video resolution.

    step(bank, frame_u8 (H, W, 3) on the card, gather_meta's dict,
    pack_masks) -> (low-res logits (B, 1, h, w) fp32, video-res logits
    (B, 1, H, W) fp32, packed masks or None, object pointers (B, C) fp32,
    memory features (B, h', w', mem_dim))."""
    model = predictor.model
    cfg = predictor.cfg
    dev = predictor.device
    C, mem_dim = cfg.hidden_dim, cfg.mem_dim
    split = C // mem_dim if mem_dim < C else 1
    multimask = model.use_multimask(is_init_cond_frame=False, num_pts=0)
    fill_hole_area = predictor.fill_hole_area
    non_overlap = predictor.non_overlap_masks
    mean = torch.from_numpy(np.asarray(IMAGENET_MEAN, np.float32)).to(dev)
    std = torch.from_numpy(np.asarray(IMAGENET_STD, np.float32)).to(dev)

    def idx(a, dtype=torch.int64):
        return torch.from_numpy(a).to(dev, dtype)

    def step(bank: DeviceMemoryBank, frame_u8: torch.Tensor, meta: dict,
             pack_masks: bool = False):
        vh, vw = frame_u8.shape[:2]
        b, hw = bank.cond_mem.shape[1:3]
        s = cfg.image_size
        img = resize_nhwc(frame_u8.float()[None] / 255.0, (s, s), "bilinear",
                          antialias=True)
        backbone = model.forward_image((img - mean) / std)
        fpn, pos = backbone["backbone_fpn"], backbone["vision_pos_enc"]
        top, top_pos, hr0, hr1 = (t.expand(b, *t.shape[1:])
                                  for t in (fpn[-1], pos[-1], fpn[0], fpn[1]))

        # the memory from the pools
        grids = torch.cat([bank.cond_mem, bank.grid_ring])[idx(meta["g_idx"])]
        n_g = grids.shape[0]
        gpos = (bank.spatial_penc[None, None]
                + model.maskmem_tpos_enc[idx(meta["g_tpos"])].float())
        mem_tok = grids.transpose(0, 1).reshape(b, n_g * hw, mem_dim)
        pos_tok = gpos.expand(n_g, b, hw, mem_dim).transpose(0, 1).reshape(
            b, n_g * hw, mem_dim)
        valid = idx(meta["g_valid"], torch.bool).repeat_interleave(hw)
        nptr = 0
        if cfg.use_obj_ptrs_in_encoder:
            p_idx = idx(meta["p_idx"])
            nptr = p_idx.shape[0] * split
            ptrs = torch.cat([bank.cond_ptr, bank.ptr_ring])[p_idx]
            ptrs = ptrs.transpose(0, 1).reshape(b, nptr, mem_dim)
            if cfg.add_tpos_enc_to_obj_ptrs:
                tdim = C if cfg.proj_tpos_enc_in_obj_ptrs else mem_dim
                obj_pos = get_1d_sine_pe(
                    idx(meta["p_tdiff"], torch.float32) / meta["t_diff_max"],
                    tdim)
                if cfg.proj_tpos_enc_in_obj_ptrs:
                    obj_pos = model.obj_ptr_tpos_proj(obj_pos.to(model.dtype))
                obj_pos = obj_pos.float()
            else:
                obj_pos = torch.zeros(p_idx.shape[0], mem_dim, device=dev)
            obj_pos = obj_pos.repeat_interleave(split, 0)
            mem_tok = torch.cat([mem_tok.float(), ptrs], 1)
            pos_tok = torch.cat([pos_tok, obj_pos[None].expand(b, -1, -1)], 1)
            valid = torch.cat([valid, idx(meta["p_valid"], torch.bool)
                               .repeat_interleave(split)])
        dt = model.dtype
        pix = model.condition_features_on_memory(
            top, top_pos, mem_tok.to(dt), pos_tok.to(dt), nptr,
            memory_valid=valid[None].expand(b, -1))
        outs = model.forward_sam_heads(
            pix, torch.zeros(b, 1, 2, device=dev),
            -torch.ones(b, 1, dtype=torch.int32, device=dev), None, (hr0, hr1),
            multimask)
        _, _, _, low, high_res, obj_ptr, _ = outs
        feats, _ = model.encode_new_memory(top, high_res, is_mask_from_pts=False)

        # the rings, in place
        bank._write(bank.grid_ring, meta["store_slot"], feats.reshape(b, hw, -1))
        obj_ptr = obj_ptr.float()
        bank._write(bank.ptr_ring, meta["ptr_store_slot"], obj_ptr)

        low = low.float()
        if fill_hole_area > 0:
            labels, areas = label_components_torch(low <= 0)
            low = torch.where((labels > 0) & (areas <= fill_hole_area),
                              torch.tensor(0.1, device=dev), low)
        video_res = resize_nhwc(low.permute(0, 2, 3, 1), (vh, vw),
                                "bilinear").permute(0, 3, 1, 2)
        if non_overlap:
            video_res = SAM2Base.apply_non_overlapping_constraints(video_res)
        packed = pack_bits_width(video_res > 0) if pack_masks else None
        return low, video_res, packed, obj_ptr, feats

    return step
