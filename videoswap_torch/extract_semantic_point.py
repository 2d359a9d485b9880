"""Semantic point extraction, the port of extract_semantic_point.py:

    python3 -m videoswap_torch.extract_semantic_point --frame_dir D
        [--is_human false] [--keyframe_annotation K.json]
        [--subject_category C] [--model_opt <yaml>] [--pose_ckpt P]
        [--device cpu]

writes `<parent of D>/TAP.pth`, the reference's format: {pred_tracks
[F, P, 2], point_name2id, point_embedding [P, 1280]}.

- Humans (`--is_human true`): 18 OpenPose keypoints a frame, from
  controlnet_aux's detector where it loads, else the native body model
  (preprocess/pose.py) on `--pose_ckpt` / $VS_OPENPOSE_CKPT /
  pretrained_models/body_pose_model.pth; each point's embedding is the mean
  of its DIFT vectors over the frames where it was found.
- Objects and animals: the keyframe annotation's points ({name: [y, x]};
  the file's stem is the keyframe's index) tracked by a thirdparty
  co-tracker checkout, else the native CoTracker where its checkpoint is on
  disk (preprocess/cotracker_native.py), else the DIFT tracker
  (preprocess/tracker.py); each point's embedding is the mean of its DIFT
  vectors over the frames whose cosine to the keyframe's vector reaches
  0.35, the others marked [-1, -1], as are points out of the frame.

The models come from `--model_opt` (its `models` and `path` blocks, as the
swap CLI builds them), random without it, as the JAX package's are. Every
frame's DIFT features are computed once a run (the JAX package computes
them twice, with the same draw), and the embeddings read the resized maps
at the tracked pixels alone. It runs on the GPU (the U-Net and VAE in
bf16, the trackers and the pose model in fp32 with TF32 off) unless
`--device cpu` is given (fp32). Which tracker or detector ran is logged
and returned.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from videoswap_torch.preprocess.dift import (SDFeaturizer, dift_query,
                                             feature_at)
from videoswap_torch.preprocess.tracker import (DIFTTracker,
                                                load_thirdparty_cotracker)
from videoswap_torch.utils.logger import get_logger
from videoswap_torch.utils.vis_util import OPENPOSE_NAME2ID


def _load_frames(frame_dir: str) -> tuple[list, list[np.ndarray]]:
    """The frames of `frame_dir` in name order: PIL images and (H, W, 3)
    float32 arrays in [-1, 1]."""
    paths = sorted(Path(frame_dir).iterdir())
    pil = [Image.open(p).convert('RGB') for p in paths]
    arrs = [np.asarray(p, np.float32) / 127.5 - 1.0 for p in pil]
    return pil, arrs


def _build_pose_detector(pose_ckpt: str | None, device=None):
    """controlnet_aux's detector where it loads (the reference's), else the
    native OpenPose body model on a local body_pose_model.pth."""
    try:
        from controlnet_aux import OpenposeDetector  # type: ignore
        return OpenposeDetector.from_pretrained('lllyasviel/Annotators')
    except ImportError:
        pass
    except Exception as e:  # noqa: BLE001 - from_pretrained needs the
        # network; without it, it raises other errors than ImportError
        get_logger().info(f'controlnet_aux unavailable ({e}); '
                          'falling back to native OpenPose')
    from videoswap_torch.preprocess.pose import NativePoseDetector
    pose_ckpt = pose_ckpt or os.environ.get(
        'VS_OPENPOSE_CKPT', 'pretrained_models/body_pose_model.pth')
    if not osp.isfile(pose_ckpt):
        raise RuntimeError(
            'human keypoint extraction needs either controlnet_aux or a '
            f'local OpenPose body checkpoint (looked at {pose_ckpt}; set '
            '--pose_ckpt or VS_OPENPOSE_CKPT), or use --is_human false '
            'with a keyframe annotation')
    return NativePoseDetector.from_checkpoint(pose_ckpt, device=device)


def propagate_human_keypoint(frame_dir: str, detector) -> dict:
    """OpenPose's 18 keypoints in every frame (reference :34-77): the first
    person's, -1 where a keypoint was not found. detector: a
    `_build_pose_detector` result."""
    get_logger().info(f'keypoints from {type(detector).__name__}')
    pil, _ = _load_frames(frame_dir)
    tracks = np.full((len(pil), 18, 2), -1.0, np.float32)
    for fi, img in enumerate(pil):
        pose = detector.detect_poses(np.asarray(img))
        if pose:
            kps = pose[0].body.keypoints
            w, h = img.size
            for ki, kp in enumerate(kps[:18]):
                if kp is not None:
                    tracks[fi, ki] = (kp.x * w, kp.y * h)
    return {'pred_tracks': tracks, 'point_name2id': dict(OPENPOSE_NAME2ID)}


def select_tracker() -> tuple[str, object]:
    """The tracker the JAX package picks: ('thirdparty', its predictor
    class) where a co-tracker checkout imports, ('native_cotracker', the
    checkpoint) where the published checkpoint is on disk, else ('dift',
    None)."""
    from videoswap_torch.preprocess.cotracker_native import \
        find_cotracker_checkpoint
    cls = load_thirdparty_cotracker()
    if cls is not None:
        return 'thirdparty', cls
    ckpt = find_cotracker_checkpoint()
    if ckpt is not None:
        return 'native_cotracker', ckpt
    return 'dift', None


def read_annotation(annotation_path: str) -> tuple[int, list, np.ndarray]:
    """A keyframe annotation ({name: [y, x]}, entries without a point
    left out): (keyframe index from the file's stem, names, (P, 2) x, y)."""
    with open(annotation_path) as f:
        anno = json.load(f)
    keyframe_idx = int(osp.splitext(osp.basename(annotation_path))[0])
    names = [k for k, v in anno.items() if len(v)]
    points_xy = np.asarray([[anno[k][1], anno[k][0]] for k in names],
                           np.float32)
    return keyframe_idx, names, points_xy


def propagate_general_keypoint(frame_dir: str, annotation_path: str,
                               featurizer: SDFeaturizer, category: str,
                               feats: list, tracker, device) -> dict:
    """The keyframe's points tracked through the clip (reference :80-111).
    feats: every frame's DIFT map; tracker: a `select_tracker()` result."""
    keyframe_idx, names, points_xy = read_annotation(annotation_path)
    _, arrs = _load_frames(frame_dir)
    kind, source = tracker
    if kind == 'thirdparty':
        get_logger().info('tracking with thirdparty co-tracker')
        video = torch.from_numpy(
            (np.stack(arrs) / 2 + 0.5) * 255).permute(0, 3, 1, 2)[None]
        queries = torch.tensor(
            [[keyframe_idx, x, y] for x, y in points_xy])[None].float()
        pred, _ = source()(video, queries=queries, backward_tracking=True)
        tracks = pred[0].numpy().astype(np.float32)
    elif kind == 'native_cotracker':
        from videoswap_torch.preprocess.cotracker_native import \
            NativeCoTrackerPredictor
        get_logger().info(f'tracking with native co-tracker ({source})')
        predictor = NativeCoTrackerPredictor.from_checkpoint(
            source, device=device)
        video = (np.stack(arrs) / 2 + 0.5) * 255
        queries = np.asarray([[keyframe_idx, x, y] for x, y in points_xy],
                             np.float32)[None]
        pred, _ = predictor(video, queries, backward_tracking=True)
        tracks = pred[0].astype(np.float32)
    else:
        get_logger().info('tracking with native DIFT tracker')
        tracks = DIFTTracker(featurizer, device=device).track(
            arrs, keyframe_idx, points_xy, category, feats=feats)
    return {'pred_tracks': tracks,
            'point_name2id': {n: i for i, n in enumerate(names)}}


def frame_features(featurizer: SDFeaturizer, arrs: list,
                   category: str) -> list:
    """Every frame's DIFT map under 'photo of a {category}'."""
    return [featurizer.forward(a, f'photo of a {category}') for a in arrs]


def extract_point_embedding(tap_dict: dict, frame_dir: str,
                            keyframe_annotation_path: str | None,
                            is_human: bool, feats: list) -> dict:
    """Each point's DIFT embedding (reference :114-191) from every frame's
    DIFT map `feats`, the tracks marked where the object path's confidence
    fails."""
    _, arrs = _load_frames(frame_dir)
    tracks = np.asarray(tap_dict['pred_tracks'], np.float32)
    f, p = tracks.shape[:2]
    emb = None
    count = np.zeros(p)

    if is_human:
        for fi, a in enumerate(arrs):
            h, w = a.shape[:2]
            if emb is None:
                emb = np.zeros((p, feats[fi].shape[-1]), np.float32)
            seen = [pi for pi in range(p)
                    if tracks[fi, pi, 0] >= 0 and tracks[fi, pi, 1] >= 0]
            if not seen:
                continue
            # Python's round, halves to even, as the reference's
            ys = [int(round(tracks[fi, pi, 1])) % h for pi in seen]
            xs = [int(round(tracks[fi, pi, 0])) % w for pi in seen]
            vecs = feature_at(feats[fi], (h, w), ys, xs).cpu().numpy()
            for pi, vec in zip(seen, vecs):
                emb[pi] += vec
                count[pi] += 1
    else:
        threshold = 0.35
        key_idx = int(osp.splitext(
            osp.basename(keyframe_annotation_path))[0])
        h, w = arrs[0].shape[:2]
        for fi in range(f):
            for pi in range(p):
                sx, sy = tracks[key_idx, pi]
                tx, ty = tracks[fi, pi]
                if tx >= w or ty >= h or tx < 0 or ty < 0:
                    tracks[fi, pi] = (-1, -1)
                    continue
                _, conf, vec = dift_query(feats[key_idx], (h, w), (sx, sy),
                                          feats[fi], (h, w), (tx, ty))
                if emb is None:
                    emb = np.zeros((p, len(vec)), np.float32)
                if conf >= threshold:
                    emb[pi] += vec
                    count[pi] += 1
                else:
                    tracks[fi, pi] = (-1, -1)
    count = np.maximum(count, 1)
    tap_dict['pred_tracks'] = tracks
    tap_dict['point_embedding'] = (emb / count[:, None]).astype(np.float32)
    return tap_dict


def save_tap(tap: dict, path: str) -> None:
    out = {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
           else v for k, v in tap.items()}
    torch.save(out, path)


def build_featurizer(model_opt: str | None, device,
                     root_path: str = '.') -> SDFeaturizer:
    """The SD featurizer on the models `model_opt` names (random without
    one), bf16 on the GPU, fp32 on the CPU."""
    from videoswap_torch.builders import build_models
    from videoswap_torch.utils.config import load_config
    opt = load_config(model_opt) if model_opt else {'models': {}}
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    models = build_models(opt, os.path.abspath(root_path), device=device,
                          dtype=dtype)
    return SDFeaturizer(unet=models['unet'], vae=models['vae'],
                        text_encoder=models['text_encoder'],
                        tokenizer=models['tokenizer'], sched=models['sched'])


def run(frame_dir: str, is_human: bool = False,
        keyframe_annotation: str | None = None,
        subject_category: str = 'object', model_opt: str | None = None,
        pose_ckpt: str | None = None, device=None) -> dict:
    """The CLI's work. Returns {'path', 'tap', 'source' (the tracker or
    detector that ran), 'seconds' (each stage's), 'peak_gib' (on the GPU),
    'featurizer', 'features' (each frame's DIFT map)}."""
    from videoswap_torch.utils.device import cli_device
    device = cli_device(device)
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    seconds = {}
    t0 = time.perf_counter()

    def mark(stage):
        nonlocal t0
        if cuda:
            torch.cuda.synchronize(device)
        seconds[stage] = time.perf_counter() - t0
        t0 = time.perf_counter()

    featurizer = build_featurizer(model_opt, device)
    mark('load')
    _, arrs = _load_frames(frame_dir)
    feats = frame_features(featurizer, arrs, subject_category)
    mark('features')
    if is_human:
        detector = _build_pose_detector(pose_ckpt, device)
        source = type(detector).__name__
        tap = propagate_human_keypoint(frame_dir, detector)
    else:
        tracker = select_tracker()
        source = tracker[0]
        tap = propagate_general_keypoint(
            frame_dir, keyframe_annotation, featurizer, subject_category,
            feats=feats, tracker=tracker, device=device)
    mark('track')
    tap = extract_point_embedding(tap, frame_dir, keyframe_annotation,
                                  is_human, feats)
    mark('embed')
    out_path = os.path.join(os.path.dirname(frame_dir), 'TAP.pth')
    save_tap(tap, out_path)
    mark('save')
    print(f'saved {out_path}', flush=True)
    return {'path': out_path, 'tap': tap, 'source': source,
            'seconds': seconds,
            'peak_gib': (torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if cuda else None),
            'featurizer': featurizer, 'features': feats}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--frame_dir', type=str, required=True)
    parser.add_argument('--is_human', type=str, default='false')
    parser.add_argument('--keyframe_annotation', type=str, default=None)
    parser.add_argument('--subject_category', type=str, default='object')
    parser.add_argument('--model_opt', type=str, default=None,
                        help='YAML with models/path blocks (for SD weights)')
    parser.add_argument('--pose_ckpt', type=str, default=None,
                        help='OpenPose body_pose_model.pth for the native '
                             'human-keypoint path (no controlnet_aux)')
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs on the CPU; the default is 'cuda'")
    args = parser.parse_args(argv)
    return run(args.frame_dir,
               args.is_human.lower() in ('1', 'true', 'yes'),
               args.keyframe_annotation, args.subject_category,
               args.model_opt, args.pose_ckpt, args.device)


if __name__ == '__main__':
    main()
