"""SAM2 video predictor: an interactive tracker of several objects through a
video (the port's copy of the JAX package's `predictors/video_predictor.py`,
sam2/sam2_video_predictor.py:17-898).

The host keeps the state machine: the prompts of each object, the outputs
of conditioning (prompted) and tracked frames, and the choice of memories.
The card runs the model. Two ways to track a frame:

1. `device_resident=True`, the default: the memory bank lives in tensors
   of fixed shape on the card (`predictors/video_device.py`), a bank of the
   conditioning frames made once per propagation pass plus two rings
   written in place. One function per frame takes the uint8 frame there:
   preprocess, image encoder, memory attention over the bank, SAM heads,
   memory encoder, ring update, hole filling, masks at video resolution.
   The host computes only gather indices and validity bits.
2. The prompts, and `device_resident=False`: the memory bank is gathered
   on the host and padded to fixed slot counts (`num_maskmem` grids and
   the object pointers' slots, the pad keys masked out of the
   cross-attention).

Both give the same masks. Frames stay on the host as uint8 numpy; the
image features of the last frame used are cached, as the reference's
`cached_features`. Only frames with fresh prompts are served from cache
by `propagate_in_video`; every other frame is tracked again on each call,
so a correction propagates.

Every entry point runs under `torch.inference_mode()` on the model's
device. Outputs kept in the state are fp32 numpy on the host path and
tensors on the card on the device path (numpy with
`offload_state_to_cpu`). The prompts return numpy masks, as the JAX
package's do; `propagate_in_video` yields tensors on the model's device,
as the reference does.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from sam2unet_torch.models.position_encoding import get_1d_sine_pe
from sam2unet_torch.models.sam2_base import NO_OBJ_SCORE, SAM2Base
from sam2unet_torch.ops.connected_components import label_components_native
from sam2unet_torch.ops.resize_np import resize_np
from sam2unet_torch.predictors.transforms import SAM2Transforms


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as fp32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def select_closest_cond_frames(frame_idx, cond_frame_outputs,
                               max_cond_frame_num):
    """(sam2_utils.py:15-57)."""
    if max_cond_frame_num == -1 or len(cond_frame_outputs) <= max_cond_frame_num:
        return cond_frame_outputs, {}
    assert max_cond_frame_num >= 2
    selected = {}
    idx_before = max((t for t in cond_frame_outputs if t < frame_idx),
                     default=None)
    if idx_before is not None:
        selected[idx_before] = cond_frame_outputs[idx_before]
    idx_after = min((t for t in cond_frame_outputs if t >= frame_idx),
                    default=None)
    if idx_after is not None:
        selected[idx_after] = cond_frame_outputs[idx_after]
    remain = sorted((t for t in cond_frame_outputs if t not in selected),
                    key=lambda x: abs(x - frame_idx))
    remain = remain[:max_cond_frame_num - len(selected)]
    selected.update((t, cond_frame_outputs[t]) for t in remain)
    unselected = {t: v for t, v in cond_frame_outputs.items()
                  if t not in selected}
    return selected, unselected


def memory_frame(frame_idx: int, t_pos: int, num_maskmem: int, r: int,
                 reverse: bool) -> int:
    """The frame whose memory fills slot `t_pos` (1 .. num_maskmem - 1)
    when tracking `frame_idx` (sam2_base.py:527-552): the previous frame,
    then every r-th frame before it."""
    t_rel = num_maskmem - t_pos
    if t_rel == 1:
        return frame_idx + 1 if reverse else frame_idx - 1
    if not reverse:
        return ((frame_idx - 2) // r) * r - (t_rel - 2) * r
    return -(-(frame_idx + 2) // r) * r + (t_rel - 2) * r


class SAM2VideoPredictor:
    def __init__(self, model: SAM2Base, fill_hole_area: int = 0,
                 non_overlap_masks: bool = False,
                 clear_non_cond_mem_around_input: bool = False,
                 clear_non_cond_mem_for_multi_obj: bool = False,
                 device_resident: bool = True):
        self.model = model.eval()
        self.cfg = model.cfg
        self.device = model.no_mem_embed.device
        self.fill_hole_area = fill_hole_area
        self.non_overlap_masks = non_overlap_masks
        self.clear_non_cond_mem_around_input = clear_non_cond_mem_around_input
        self.clear_non_cond_mem_for_multi_obj = clear_non_cond_mem_for_multi_obj
        self.device_resident = device_resident and self.cfg.num_maskmem > 0
        self._device_step = None
        self._transforms = SAM2Transforms(self.cfg.image_size,
                                          mask_threshold=0.0)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(np.array(x)).to(self.device, dtype)

    # -------------------------------------------------------------- state

    @torch.inference_mode()
    def init_state(self, video_path: str | None = None,
                   images: np.ndarray | None = None,
                   offload_video_to_cpu: bool = False,
                   offload_state_to_cpu: bool = False,
                   async_loading_frames: bool = False) -> dict:
        """images (T, H, W, 3) RGB uint8, or video_path, a directory of frame
        JPEG/PNGs named by index (misc.py:163-213). Frames stay on the host
        whatever `offload_video_to_cpu` says (each tracked frame is copied
        to the card as uint8). With `offload_state_to_cpu` the device path's
        outputs come back to host numpy each frame (the reference's
        storage_device=cpu). `async_loading_frames` returns after decoding
        the first frame and decodes the rest on a thread (misc.py:
        104-160)."""
        if images is None:
            from sam2unet_torch.utils import video

            if async_loading_frames:
                images = video.AsyncVideoFrameLoader(video_path)
                orig_h, orig_w = images.video_height, images.video_width
            else:
                images, orig_h, orig_w = video.load_video_frames(video_path)
        else:
            orig_h, orig_w = images.shape[1:3]
        state = {
            "images": images,
            "num_frames": len(images),
            "offload_video_to_cpu": offload_video_to_cpu,
            "offload_state_to_cpu": offload_state_to_cpu,
            "video_height": orig_h,
            "video_width": orig_w,
            "point_inputs_per_obj": {},
            "mask_inputs_per_obj": {},
            "cached_features": {},
            "obj_id_to_idx": OrderedDict(),
            "obj_idx_to_id": OrderedDict(),
            "obj_ids": [],
            "output_dict": {"cond_frame_outputs": {},
                            "non_cond_frame_outputs": {}},
            "output_dict_per_obj": {},
            "temp_output_dict_per_obj": {},
            "consolidated_frame_inds": {"cond_frame_outputs": set(),
                                        "non_cond_frame_outputs": set()},
            "tracking_has_started": False,
            "frames_already_tracked": {},
        }
        self._get_image_feature(state, frame_idx=0, batch_size=1)
        return state

    def reset_state(self, state: dict) -> None:
        self._reset_tracking_results(state)
        for key in ("obj_id_to_idx", "obj_idx_to_id", "obj_ids",
                    "point_inputs_per_obj", "mask_inputs_per_obj",
                    "output_dict_per_obj", "temp_output_dict_per_obj"):
            state[key].clear()

    def _reset_tracking_results(self, state: dict) -> None:
        for v in state["point_inputs_per_obj"].values():
            v.clear()
        for v in state["mask_inputs_per_obj"].values():
            v.clear()
        for per_obj in ("output_dict_per_obj", "temp_output_dict_per_obj"):
            for v in state[per_obj].values():
                v["cond_frame_outputs"].clear()
                v["non_cond_frame_outputs"].clear()
        for key in ("cond_frame_outputs", "non_cond_frame_outputs"):
            state["output_dict"][key].clear()
            state["consolidated_frame_inds"][key].clear()
        state["tracking_has_started"] = False
        state["frames_already_tracked"].clear()

    def _obj_id_to_idx(self, state: dict, obj_id: int) -> int:
        """(sam2_video_predictor.py:106-146)."""
        obj_idx = state["obj_id_to_idx"].get(obj_id)
        if obj_idx is not None:
            return obj_idx
        if state["tracking_has_started"]:
            raise RuntimeError("Cannot add new object id after tracking "
                               "starts; call reset_state to restart.")
        obj_idx = len(state["obj_id_to_idx"])
        state["obj_id_to_idx"][obj_id] = obj_idx
        state["obj_idx_to_id"][obj_idx] = obj_id
        state["obj_ids"] = list(state["obj_id_to_idx"])
        state["point_inputs_per_obj"][obj_idx] = {}
        state["mask_inputs_per_obj"][obj_idx] = {}
        for per_obj in ("output_dict_per_obj", "temp_output_dict_per_obj"):
            state[per_obj][obj_idx] = {"cond_frame_outputs": {},
                                       "non_cond_frame_outputs": {}}
        return obj_idx

    # ------------------------------------------------------------- inputs

    def _prompt_frame(self, state, obj_idx, frame_idx):
        """(is_init_cond_frame, reverse, storage key) of a prompt."""
        is_init = frame_idx not in state["frames_already_tracked"]
        reverse = (False if is_init
                   else state["frames_already_tracked"][frame_idx]["reverse"])
        is_cond = is_init or self.cfg.add_all_frames_to_correct_as_cond
        key = "cond_frame_outputs" if is_cond else "non_cond_frame_outputs"
        return is_init, reverse, key

    def _finish_prompt(self, state, obj_idx, frame_idx, key, current_out):
        """Store a prompt's output and return the frame's masks of every
        object at video resolution (sam2_video_predictor.py:236-255)."""
        state["temp_output_dict_per_obj"][obj_idx][key][frame_idx] = current_out
        consolidated = self._consolidate_temp_output_across_obj(
            state, frame_idx, is_cond=key == "cond_frame_outputs",
            run_mem_encoder=False, consolidate_at_video_res=True)
        _, video_res_masks = self._get_orig_video_res_output(
            state, consolidated["pred_masks_video_res"])
        return frame_idx, state["obj_ids"], video_res_masks

    @torch.inference_mode()
    def add_new_points(self, inference_state: dict, frame_idx: int,
                       obj_id: int, points, labels,
                       clear_old_points: bool = True,
                       normalize_coords: bool = True):
        """(sam2_video_predictor.py:148-255): points (N, 2) XY in pixels
        (or in [0, 1] with normalize_coords=False), labels (N,) 1/0."""
        state = inference_state
        obj_idx = self._obj_id_to_idx(state, obj_id)
        points = np.asarray(points, np.float32)
        labels = np.asarray(labels, np.int32)
        if points.ndim == 2:
            points = points[None]
        if labels.ndim == 1:
            labels = labels[None]
        if normalize_coords:
            points = points / np.asarray(
                [state["video_width"], state["video_height"]], np.float32)
        points = points * self.cfg.image_size
        if not clear_old_points:
            old = state["point_inputs_per_obj"][obj_idx].get(frame_idx)
            if old is not None:
                points = np.concatenate([old["point_coords"], points], axis=1)
                labels = np.concatenate([old["point_labels"], labels], axis=1)
        point_inputs = {"point_coords": points, "point_labels": labels}
        state["point_inputs_per_obj"][obj_idx][frame_idx] = point_inputs
        state["mask_inputs_per_obj"][obj_idx].pop(frame_idx, None)

        is_init, reverse, key = self._prompt_frame(state, obj_idx, frame_idx)
        obj_out = state["output_dict_per_obj"][obj_idx]
        prev_out = state["temp_output_dict_per_obj"][obj_idx][key].get(frame_idx)
        if prev_out is None:
            prev_out = obj_out["cond_frame_outputs"].get(frame_idx)
            if prev_out is None:
                prev_out = obj_out["non_cond_frame_outputs"].get(frame_idx)
        prev_logits = None
        if prev_out is not None and prev_out.get("pred_masks") is not None:
            prev_logits = np.clip(to_numpy(prev_out["pred_masks"]), -32.0, 32.0)
        current_out = self._run_single_frame_inference(
            state, obj_out, frame_idx, 1, is_init, point_inputs, None, reverse,
            run_mem_encoder=False, prev_sam_mask_logits=prev_logits)
        return self._finish_prompt(state, obj_idx, frame_idx, key, current_out)

    add_new_points_or_box = add_new_points

    @torch.inference_mode()
    def add_new_mask(self, inference_state: dict, frame_idx: int, obj_id: int,
                     mask):
        """(sam2_video_predictor.py:257-336): mask (H, W) bool or 0/1."""
        state = inference_state
        obj_idx = self._obj_id_to_idx(state, obj_id)
        mask = np.asarray(mask)
        if mask.ndim != 2:
            raise ValueError(f"add_new_mask takes an (H, W) mask, got "
                             f"{mask.shape}")
        s = self.cfg.image_size
        mask_f = mask.astype(np.float32)[None, None]
        if mask.shape != (s, s):
            mask_f = resize_np(mask_f, (s, s), "bilinear", antialias=True)
            mask_f = (mask_f >= 0.5).astype(np.float32)
        state["mask_inputs_per_obj"][obj_idx][frame_idx] = mask_f
        state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        is_init, reverse, key = self._prompt_frame(state, obj_idx, frame_idx)
        current_out = self._run_single_frame_inference(
            state, state["output_dict_per_obj"][obj_idx], frame_idx, 1,
            is_init, None, mask_f, reverse, run_mem_encoder=False)
        return self._finish_prompt(state, obj_idx, frame_idx, key, current_out)

    # ------------------------------------------------------------ outputs

    def _get_orig_video_res_output(self, state, any_res_masks):
        """(sam2_video_predictor.py:338-358): the masks at the video's
        resolution, numpy, with the non-overlap constraint if asked."""
        h, w = state["video_height"], state["video_width"]
        masks = to_numpy(any_res_masks)
        video_res = (masks if masks.shape[-2:] == (h, w)
                     else resize_np(masks, (h, w), "bilinear"))
        if self.non_overlap_masks:
            video_res = SAM2Base.apply_non_overlapping_constraints(
                torch.from_numpy(video_res)).numpy()
        return masks, video_res

    def _consolidate_temp_output_across_obj(self, state, frame_idx, is_cond,
                                            run_mem_encoder,
                                            consolidate_at_video_res=False):
        """(sam2_video_predictor.py:360-476): the objects' latest outputs on
        this frame as one batch; at video resolution for the interactive
        return, else at the low resolution with the memory encoded."""
        batch_size = len(state["obj_idx_to_id"])
        key = "cond_frame_outputs" if is_cond else "non_cond_frame_outputs"
        if consolidate_at_video_res:
            assert not run_mem_encoder, "video-res consolidation is UI-only"
            mh, mw = state["video_height"], state["video_width"]
            mask_key = "pred_masks_video_res"
        else:
            mh = mw = self.cfg.image_size // 4
            mask_key = "pred_masks"
        consolidated = {
            "maskmem_features": None,
            "maskmem_pos_enc": None,
            mask_key: np.full((batch_size, 1, mh, mw), NO_OBJ_SCORE,
                              np.float32),
            "obj_ptr": np.full((batch_size, self.cfg.hidden_dim), NO_OBJ_SCORE,
                               np.float32),
        }
        empty_mask_ptr = None
        for obj_idx in range(batch_size):
            out = state["temp_output_dict_per_obj"][obj_idx][key].get(frame_idx)
            for stored in ("cond_frame_outputs", "non_cond_frame_outputs"):
                if out is None:
                    out = state["output_dict_per_obj"][obj_idx][stored].get(
                        frame_idx)
            if out is None:
                # no output of this object here: for the memory, its pointer
                # from an empty-mask prediction, not the NO_OBJ_SCORE fill
                # (sam2_video_predictor.py:426-438)
                if run_mem_encoder:
                    if empty_mask_ptr is None:
                        empty_mask_ptr = self._get_empty_mask_ptr(state,
                                                                  frame_idx)
                    consolidated["obj_ptr"][obj_idx:obj_idx + 1] = empty_mask_ptr
                continue
            masks = to_numpy(out["pred_masks"])
            if masks.shape[-2:] != (mh, mw):
                masks = resize_np(masks, (mh, mw), "bilinear")
            consolidated[mask_key][obj_idx:obj_idx + 1] = masks
            consolidated["obj_ptr"][obj_idx:obj_idx + 1] = to_numpy(out["obj_ptr"])
        if not consolidate_at_video_res:
            consolidated["pred_masks_video_res"] = consolidated["pred_masks"]
        if run_mem_encoder:
            s = self.cfg.image_size
            hi = resize_np(consolidated["pred_masks"], (s, s), "bilinear")
            feats, pos = self._run_memory_encoder(state, frame_idx, batch_size,
                                                  hi, is_mask_from_pts=True)
            consolidated["maskmem_features"] = feats
            consolidated["maskmem_pos_enc"] = pos
        return consolidated

    def _get_empty_mask_ptr(self, state, frame_idx: int) -> np.ndarray:
        """The object pointer of an empty mask on this frame
        (sam2_video_predictor.py:479-512)."""
        s = self.cfg.image_size
        out = self._run_single_frame_inference(
            state, {}, frame_idx, 1, True, None,
            np.zeros((1, 1, s, s), np.float32), False, run_mem_encoder=False)
        return out["obj_ptr"]

    # ---------------------------------------------------------- main loop

    def propagate_in_video_preflight(self, state: dict):
        """(sam2_video_predictor.py:514-582): consolidate the prompts'
        outputs, encode their memory, mark those frames to be served."""
        state["tracking_has_started"] = True
        batch_size = len(state["obj_idx_to_id"])
        if batch_size == 0:
            raise RuntimeError("add inputs before propagation")
        temp_inds = {"cond_frame_outputs": set(),
                     "non_cond_frame_outputs": set()}
        for obj_temp in state["temp_output_dict_per_obj"].values():
            for key in temp_inds:
                temp_inds[key].update(obj_temp[key])
        for is_cond in (False, True):
            key = "cond_frame_outputs" if is_cond else "non_cond_frame_outputs"
            # only frames with fresh prompts are served from cache later;
            # every other frame is tracked again (the reference's
            # consolidated_frame_inds, sam2_video_predictor.py:528-538)
            state["consolidated_frame_inds"][key].update(temp_inds[key])
            for frame_idx in sorted(temp_inds[key]):
                consolidated = self._consolidate_temp_output_across_obj(
                    state, frame_idx, is_cond=is_cond, run_mem_encoder=True)
                # cleared before the store (the reference clears after, and
                # drops a non-cond prompt frame's own output)
                if self._clear_non_cond(batch_size):
                    self._clear_non_cond_mem_around_input(state, frame_idx)
                state["output_dict"][key][frame_idx] = consolidated
                self._add_output_per_object(state, frame_idx, consolidated,
                                            key)
            for obj_temp in state["temp_output_dict_per_obj"].values():
                obj_temp[key].clear()
        for frame_idx in state["output_dict"]["cond_frame_outputs"]:
            state["output_dict"]["non_cond_frame_outputs"].pop(frame_idx, None)
            for obj_out in state["output_dict_per_obj"].values():
                obj_out["non_cond_frame_outputs"].pop(frame_idx, None)
        for frame_idx in state["consolidated_frame_inds"]["cond_frame_outputs"]:
            state["consolidated_frame_inds"]["non_cond_frame_outputs"].discard(
                frame_idx)

    def _clear_non_cond(self, batch_size: int) -> bool:
        return self.clear_non_cond_mem_around_input and (
            self.clear_non_cond_mem_for_multi_obj or batch_size <= 1)

    def propagate_in_video(self, inference_state: dict,
                           start_frame_idx: int | None = None,
                           max_frame_num_to_track: int | None = None,
                           reverse: bool = False,
                           yield_packed_masks: bool = False):
        """Generator of (frame_idx, obj_ids, video_res_masks)
        (sam2_video_predictor.py:584-667): masks (objects, 1, H, W) logits
        at the video's resolution, a tensor on the model's device, as the
        reference yields them. With `yield_packed_masks` they are (mask > 0)
        packed along the width into uint8 (np.unpackbits(m, axis=-1)
        [..., :W] undoes it)."""
        with torch.inference_mode():
            yield from self._propagate(inference_state, start_frame_idx,
                                       max_frame_num_to_track, reverse,
                                       yield_packed_masks)

    def _propagate(self, state, start_frame_idx, max_frame_num_to_track,
                   reverse, yield_packed_masks):
        self.propagate_in_video_preflight(state)
        output_dict = state["output_dict"]
        num_frames = state["num_frames"]
        batch_size = len(state["obj_idx_to_id"])
        if not output_dict["cond_frame_outputs"]:
            raise RuntimeError("No points provided; please add points first")
        if start_frame_idx is None:
            start_frame_idx = min(output_dict["cond_frame_outputs"])
        if max_frame_num_to_track is None:
            max_frame_num_to_track = num_frames
        if reverse:
            end = max(start_frame_idx - max_frame_num_to_track, 0)
            order = (range(start_frame_idx, end - 1, -1)
                     if start_frame_idx > 0 else [])
        else:
            end = min(start_frame_idx + max_frame_num_to_track, num_frames - 1)
            order = range(start_frame_idx, end + 1)

        bank = None
        if self.device_resident:
            from sam2unet_torch.predictors import video_device

            bank = video_device.DeviceMemoryBank(self, state, output_dict,
                                                 batch_size)
            if self._device_step is None:
                self._device_step = video_device.build_device_track_step(self)

        served = state["consolidated_frame_inds"]
        for frame_idx in order:
            device_masks = None
            if frame_idx in served["cond_frame_outputs"]:
                current_out = output_dict["cond_frame_outputs"][frame_idx]
                if self._clear_non_cond(batch_size):
                    self._clear_non_cond_mem_around_input(state, frame_idx)
            elif frame_idx in served["non_cond_frame_outputs"]:
                current_out = output_dict["non_cond_frame_outputs"][frame_idx]
            else:
                if bank is not None:
                    current_out, device_masks = self._run_device_frame(
                        state, bank, frame_idx, reverse, yield_packed_masks)
                else:
                    current_out = self._run_single_frame_inference(
                        state, output_dict, frame_idx, batch_size, False, None,
                        None, reverse, run_mem_encoder=True)
                output_dict["non_cond_frame_outputs"][frame_idx] = current_out
                self._add_output_per_object(state, frame_idx, current_out,
                                            "non_cond_frame_outputs")
            state["frames_already_tracked"][frame_idx] = {"reverse": reverse}
            if device_masks is not None:
                video_res_masks = device_masks
            else:
                _, video_res_masks = self._get_orig_video_res_output(
                    state, current_out["pred_masks"])
                if yield_packed_masks:
                    video_res_masks = np.packbits(video_res_masks > 0, axis=-1)
                video_res_masks = torch.from_numpy(video_res_masks).to(
                    self.device)
            yield frame_idx, state["obj_ids"], video_res_masks

    def _run_device_frame(self, state, bank, frame_idx, reverse,
                          yield_packed_masks):
        """Track one frame on the card with the device bank (one call of the
        device step; the bank's rings written in place)."""
        meta = bank.gather_meta(state, state["output_dict"], frame_idx,
                                reverse)
        frame = torch.from_numpy(np.ascontiguousarray(
            state["images"][frame_idx])).to(self.device)
        low, video_res, packed, obj_ptr, feats = self._device_step(
            bank, frame, meta, pack_masks=yield_packed_masks)
        bank.note_tracked(frame_idx)
        if state["offload_state_to_cpu"]:
            low, obj_ptr, feats = (to_numpy(t) for t in (low, obj_ptr, feats))
        current_out = {"point_inputs": None, "mask_inputs": None,
                       "pred_masks": low, "obj_ptr": obj_ptr,
                       "maskmem_features": feats,
                       "maskmem_pos_enc": bank.penc_list}
        return current_out, packed if yield_packed_masks else video_res

    def _add_output_per_object(self, state, frame_idx, current_out, key):
        """(sam2_video_predictor.py:669-696)."""
        feats = current_out["maskmem_features"]
        for obj_idx in state["output_dict_per_obj"]:
            sl = slice(obj_idx, obj_idx + 1)
            state["output_dict_per_obj"][obj_idx][key][frame_idx] = {
                "maskmem_features": None if feats is None else feats[sl],
                "maskmem_pos_enc": (None if feats is None
                                    else current_out["maskmem_pos_enc"]),
                "pred_masks": current_out["pred_masks"][sl],
                "obj_ptr": current_out["obj_ptr"][sl],
            }

    def _clear_non_cond_mem_around_input(self, state, frame_idx):
        """(sam2_video_predictor.py:881-898); frames holding a consolidated
        prompt output are kept (the propagation serves them from cache)."""
        r = self.cfg.memory_temporal_stride_for_eval
        span = r * self.cfg.num_maskmem
        non_cond = state["output_dict"]["non_cond_frame_outputs"]
        keep = state["consolidated_frame_inds"]["non_cond_frame_outputs"]
        for t in range(frame_idx - span, frame_idx + span + 1):
            if t == frame_idx or t in keep:
                continue
            non_cond.pop(t, None)
            for obj_out in state["output_dict_per_obj"].values():
                obj_out["non_cond_frame_outputs"].pop(t, None)

    # ----------------------------------------------------------- features

    def _get_image_feature(self, state, frame_idx, batch_size):
        """(sam2_video_predictor.py:698-759), caching the last frame: the
        host transform (numpy), then `forward_image` on the card."""
        cached = state["cached_features"].get(frame_idx)
        if cached is None:
            x = self._transforms(state["images"][frame_idx])[None]
            cached = self.model.forward_image(self._tensor(x))
            state["cached_features"] = {frame_idx: cached}
        fpn, pos = cached["backbone_fpn"], cached["vision_pos_enc"]
        if batch_size > 1:
            fpn = [f.expand(batch_size, *f.shape[1:]) for f in fpn]
            pos = [p.expand(batch_size, *p.shape[1:]) for p in pos]
        return fpn, pos

    # ----------------------------------------------------- frame tracking

    def _gather_memory(self, state, output_dict, frame_idx, batch_size,
                       track_in_reverse):
        """The host half of _prepare_memory_conditioned_features
        (sam2_base.py:504-662): choose the memory frames and assemble the
        bank padded to fixed slot counts (num_maskmem grids, or the next
        multiple of 4 with many conditioning frames; every selected
        conditioning pointer plus max_obj_ptrs_in_encoder - 1 others), with
        its validity mask. Returns (memory, memory_pos, valid, number of
        pointer tokens), tensors on the card."""
        cfg = self.cfg
        selected_cond, unselected_cond = select_closest_cond_frames(
            frame_idx, output_dict["cond_frame_outputs"],
            cfg.max_cond_frames_in_attn)
        t_pos_and_prevs = [(0, out) for out in selected_cond.values()]
        r = cfg.memory_temporal_stride_for_eval
        for t_pos in range(1, cfg.num_maskmem):
            prev_idx = memory_frame(frame_idx, t_pos, cfg.num_maskmem, r,
                                    track_in_reverse)
            out = output_dict["non_cond_frame_outputs"].get(prev_idx)
            if out is None:
                out = unselected_cond.get(prev_idx)
            t_pos_and_prevs.append((t_pos, out))

        tpos_enc = to_numpy(self.model.maskmem_tpos_enc)
        grids, grid_pos = [], []
        for t_pos, prev in t_pos_and_prevs:
            if prev is None:
                continue
            feats = to_numpy(prev["maskmem_features"])
            b, h, w, c = feats.shape
            grids.append(feats.reshape(b, h * w, c))
            enc = to_numpy(prev["maskmem_pos_enc"][-1]).reshape(1, h * w, c)
            grid_pos.append(np.broadcast_to(enc, (b, h * w, c))
                            + tpos_enc[cfg.num_maskmem - t_pos - 1].reshape(1, 1, c))
        n_g, hw, c = len(grids), grids[0].shape[1], grids[0].shape[2]
        slots = cfg.num_maskmem if n_g <= cfg.num_maskmem else -(-n_g // 4) * 4
        zero = np.zeros((batch_size, hw, c), np.float32)
        mems = grids + [zero] * (slots - n_g)
        mem_pos = grid_pos + [zero] * (slots - n_g)
        valid = [np.ones(n_g * hw, bool), np.zeros((slots - n_g) * hw, bool)]

        n_ptr_tokens = 0
        if cfg.use_obj_ptrs_in_encoder:
            C, mem_dim = cfg.hidden_dim, cfg.mem_dim
            split = C // mem_dim if mem_dim < C else 1
            n_cond = len(output_dict["cond_frame_outputs"])
            if cfg.max_cond_frames_in_attn > 0:
                n_cond = min(n_cond, cfg.max_cond_frames_in_attn)
            ptr_slots = (n_cond + cfg.max_obj_ptrs_in_encoder - 1) * split
            max_ptrs = min(state["num_frames"], cfg.max_obj_ptrs_in_encoder)
            ptr_cond = {t: out for t, out in selected_cond.items()
                        if not cfg.only_obj_ptrs_in_the_past_for_eval
                        or (t >= frame_idx if track_in_reverse
                            else t <= frame_idx)}
            pos_and_ptrs = [(abs(frame_idx - t), out["obj_ptr"])
                            for t, out in ptr_cond.items()]
            for t_diff in range(1, max_ptrs):
                t = frame_idx + t_diff if track_in_reverse else frame_idx - t_diff
                if t < 0 or t >= state["num_frames"]:
                    break
                out = output_dict["non_cond_frame_outputs"].get(
                    t, unselected_cond.get(t))
                if out is not None:
                    pos_and_ptrs.append((t_diff, out["obj_ptr"]))
            if pos_and_ptrs:
                pos_list, ptr_list = zip(*pos_and_ptrs)
                obj_ptrs = np.stack([to_numpy(p) for p in ptr_list], axis=1)
                if cfg.add_tpos_enc_to_obj_ptrs:
                    tdim = C if cfg.proj_tpos_enc_in_obj_ptrs else mem_dim
                    obj_pos = get_1d_sine_pe(
                        torch.tensor(pos_list, dtype=torch.float32)
                        / (max_ptrs - 1), tdim).numpy()
                    if cfg.proj_tpos_enc_in_obj_ptrs:
                        proj = self.model.obj_ptr_tpos_proj
                        obj_pos = (obj_pos @ to_numpy(proj.weight).T
                                   + to_numpy(proj.bias))
                    obj_pos = np.broadcast_to(obj_pos[None],
                                              (batch_size, len(pos_list), mem_dim))
                else:
                    obj_pos = np.zeros((batch_size, len(pos_list), mem_dim),
                                       np.float32)
                if mem_dim < C:
                    obj_ptrs = obj_ptrs.reshape(batch_size, -1, mem_dim)
                    obj_pos = np.repeat(obj_pos, split, axis=1)
            else:
                obj_ptrs = np.zeros((batch_size, 0, mem_dim), np.float32)
                obj_pos = np.zeros((batch_size, 0, mem_dim), np.float32)
            p_tok = obj_ptrs.shape[1]
            pad = np.zeros((batch_size, ptr_slots - p_tok, mem_dim), np.float32)
            mems.append(np.concatenate([obj_ptrs, pad], axis=1))
            mem_pos.append(np.concatenate([obj_pos, pad], axis=1))
            valid += [np.ones(p_tok, bool), np.zeros(ptr_slots - p_tok, bool)]
            n_ptr_tokens = ptr_slots

        dt = self.model.dtype
        memory = self._tensor(np.concatenate(mems, axis=1), dt)
        memory_pos = self._tensor(np.concatenate(mem_pos, axis=1), dt)
        valid = self._tensor(np.concatenate(valid), torch.bool)
        return (memory, memory_pos, valid.expand(memory.shape[:2]),
                n_ptr_tokens)

    def _track(self, top_feat, top_pos, memory, memory_pos, valid, nptr,
               coords, labels, mask_inputs, hr0, hr1, multimask: bool,
               encode: bool, from_pts: bool):
        """track_step's device half (sam2_base.py:704-799): memory
        conditioning (none for an initial conditioning frame, `memory`
        None), the SAM heads, and with `encode` the memory encoder. Returns
        (the heads' 7-tuple, memory features or None, their encoding)."""
        m = self.model
        if memory is None:
            pix = m.condition_features_on_memory(top_feat, top_pos, None, None,
                                                 0, True)
        else:
            pix = m.condition_features_on_memory(top_feat, top_pos, memory,
                                                 memory_pos, nptr,
                                                 memory_valid=valid)
        outs = m.forward_sam_heads(pix, coords, labels, mask_inputs,
                                   (hr0, hr1), multimask)
        if not encode:
            return outs, None, None
        feats, penc = m.encode_new_memory(top_feat, outs[4], from_pts)
        return outs, feats, penc

    def _run_single_frame_inference(self, state, output_dict, frame_idx,
                                    batch_size, is_init_cond_frame,
                                    point_inputs, mask_inputs, reverse,
                                    run_mem_encoder,
                                    prev_sam_mask_logits=None):
        """track_step (sam2_base.py:704-799) driven from the host; the
        outputs as fp32 numpy."""
        cfg = self.cfg
        fpn, pos = self._get_image_feature(state, frame_idx, batch_size)
        hr0, hr1, top_feat, top_pos = fpn[0], fpn[1], fpn[-1], pos[-1]
        s = cfg.image_size
        feats = penc = None
        if mask_inputs is not None and cfg.use_mask_input_as_output_without_sam:
            mi = self._tensor(np.broadcast_to(mask_inputs.transpose(0, 2, 3, 1),
                                              (batch_size, s, s, 1)))
            sam_outputs = self.model.use_mask_as_output(top_feat, (hr0, hr1),
                                                        mi)
        else:
            memory = memory_pos = valid = None
            nptr = 0
            if not is_init_cond_frame:
                memory, memory_pos, valid, nptr = self._gather_memory(
                    state, output_dict, frame_idx, batch_size, reverse)
            mi = None
            if prev_sam_mask_logits is not None:
                mi = self._tensor(prev_sam_mask_logits.transpose(0, 2, 3, 1))
            elif mask_inputs is not None:
                # use_mask_input_as_output_without_sam=False: the mask is
                # the SAM heads' dense prompt (sam2_base.py:758-767)
                mi = self._tensor(np.broadcast_to(
                    mask_inputs.transpose(0, 2, 3, 1),
                    (batch_size, *mask_inputs.shape[2:], 1)))
            if point_inputs is not None:
                coords = self._tensor(point_inputs["point_coords"])
                labels = self._tensor(point_inputs["point_labels"], torch.int32)
                num_pts = point_inputs["point_labels"].shape[1]
            else:
                coords = torch.zeros(batch_size, 1, 2, device=self.device)
                labels = -torch.ones(batch_size, 1, dtype=torch.int32,
                                     device=self.device)
                num_pts = 0
            sam_outputs, feats, penc = self._track(
                top_feat, top_pos, memory, memory_pos, valid, nptr, coords,
                labels, mi, hr0, hr1,
                self.model.use_multimask(is_init_cond_frame, num_pts),
                encode=run_mem_encoder and cfg.num_maskmem > 0,
                from_pts=point_inputs is not None)
        _, _, _, low_res_masks, high_res_masks, obj_ptr, _ = sam_outputs
        pred_masks = to_numpy(low_res_masks)
        if self.fill_hole_area > 0:
            pred_masks = self._fill_holes(pred_masks)
        current_out = {
            "point_inputs": point_inputs,
            "mask_inputs": mask_inputs,
            "pred_masks": pred_masks,
            "pred_masks_high_res": to_numpy(high_res_masks),
            "obj_ptr": to_numpy(obj_ptr),
            "maskmem_features": None,
            "maskmem_pos_enc": None,
        }
        if feats is not None:
            current_out["maskmem_features"] = to_numpy(feats)
            current_out["maskmem_pos_enc"] = [to_numpy(p) for p in penc]
        elif run_mem_encoder and cfg.num_maskmem > 0:
            # a mask taken as the output: encode the given mask
            current_out["maskmem_features"], current_out["maskmem_pos_enc"] = (
                self._run_memory_encoder_feats(
                    top_feat, current_out["pred_masks_high_res"],
                    point_inputs is not None))
        return current_out

    def _fill_holes(self, masks: np.ndarray) -> np.ndarray:
        """Background components of at most fill_hole_area pixels become
        foreground with the score 0.1 (sam2_video_predictor.py:809-812,
        misc.py:216-228); masks (B, 1, h, w) logits."""
        labels, areas = label_components_native(masks <= 0)
        is_hole = (labels > 0) & (areas <= self.fill_hole_area)
        return np.where(is_hole, np.float32(0.1), masks)

    def _run_memory_encoder_feats(self, top_feat, high_res_masks,
                                  is_mask_from_pts):
        feats, pos = self.model.encode_new_memory(
            top_feat, self._tensor(high_res_masks), is_mask_from_pts)
        return to_numpy(feats), [to_numpy(p) for p in pos]

    def _run_memory_encoder(self, state, frame_idx, batch_size, high_res_masks,
                            is_mask_from_pts):
        fpn, _ = self._get_image_feature(state, frame_idx, batch_size)
        return self._run_memory_encoder_feats(fpn[-1], high_res_masks,
                                              is_mask_from_pts)
