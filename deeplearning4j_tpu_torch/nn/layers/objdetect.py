"""Object-detection output layer (YOLOv2).

Counterpart of ``deeplearning4j_tpu/nn/layers/objdetect.py``:
``Yolo2OutputLayer`` (``objdetect.py:42``), ``DetectedObject`` (``:111``),
``get_predicted_objects`` (``:129``) and ``non_max_suppression``
(``:163``). Layout, NHWC as in the JAX package:

    network output: [B, H, W, A*(5+C)]  (A anchors, C classes)
    labels:         [B, H, W, 5+C] = (cx, cy, w, h, obj, one-hot classes)
        cx, cy in [0, 1) within the cell; w, h in grid units; obj 1 in the
        cells that hold a box center.

The loss is the JAX layer's expression for expression: the preout cast to
f32, ``twh`` clipped to [-8, 8], the anchor IoU in the same order of
operations (so equal priors tie the same way), the responsible-anchor
one-hot ``iou >= max`` normalized by its count, and it and the objectness
target ``iou`` detached (``stop_gradient`` there).

Decoding and NMS run on the host in numpy, with no clip of ``twh``; the
decode here is vectorized and keeps the (b, i, j, a) order of the JAX
loops, because NMS sorts by confidence and ties keep their input order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer

# the type the loss computes in, whatever the preout's (the JAX layer's
# astype(float32))
LOSS_DTYPE = torch.float32


def _split_preds(preout, n_anchors, n_classes):
    B, H, W, _ = preout.shape
    p = preout.reshape(B, H, W, n_anchors, 5 + n_classes)
    return p[..., 0:2], p[..., 2:4], p[..., 4], p[..., 5:]


@register_layer
@dataclasses.dataclass(frozen=True, kw_only=True)
class Yolo2OutputLayer(Layer):
    """YOLOv2 loss head (org.deeplearning4j.nn.conf.layers.objdetect
    .Yolo2OutputLayer). ``anchors``: [(w, h), ...] priors in grid units;
    lambda_coord / lambda_no_obj 5.0 / 0.5 as in the paper."""

    anchors: Sequence = ((1.0, 1.0),)
    n_classes: int = 0
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def output_type(self, itype):
        return itype

    def preout(self, params, x):
        return x

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x, state

    def score_from_preout(self, labels, preout, mask=None):
        """Per-example YOLOv2 loss [B]."""
        A, C = len(self.anchors), self.n_classes
        pri = torch.tensor(np.asarray(self.anchors, np.float32),
                           device=preout.device)  # [A, 2]

        txy, twh, tconf, tcls = _split_preds(preout.to(LOSS_DTYPE), A, C)
        pxy = torch.sigmoid(txy)                      # within-cell offset
        pwh = pri * torch.exp(twh.clamp(-8, 8))       # grid units
        pconf = torch.sigmoid(tconf)

        labels = labels.to(LOSS_DTYPE)
        gxy = labels[..., 0:2]                        # [B, H, W, 2]
        gwh = labels[..., 2:4]
        obj = labels[..., 4]                          # [B, H, W]
        gcls = labels[..., 5:]

        # anchor-matching IoU: each prior's box against the cell's box as
        # if co-centered (the YOLOv2 responsibility criterion)
        inter = (torch.minimum(pwh[..., 0], gwh[..., None, 0])
                 * torch.minimum(pwh[..., 1], gwh[..., None, 1]))
        union = (pwh[..., 0] * pwh[..., 1]
                 + (gwh[..., 0] * gwh[..., 1])[..., None] - inter + 1e-9)
        iou = inter / union                            # [B, H, W, A]

        iou_d = iou.detach()
        resp = (iou_d >= iou_d.amax(-1, keepdim=True)).float()
        resp = resp / resp.sum(-1, keepdim=True).clamp_min(1.0)
        resp = resp * obj[..., None]                   # [B, H, W, A]

        loss_xy = ((pxy - gxy[..., None, :]) ** 2).sum(-1)
        loss_wh = ((torch.sqrt(pwh) - torch.sqrt(gwh[..., None, :] + 1e-9))
                   ** 2).sum(-1)
        loss_obj = (pconf - iou_d) ** 2
        loss_noobj = pconf ** 2
        logp = torch.log_softmax(tcls, dim=-1)
        loss_cls = -(gcls[..., None, :] * logp).sum(-1)

        per_cell = (self.lambda_coord * resp * (loss_xy + loss_wh)
                    + resp * loss_obj
                    + self.lambda_no_obj * (1.0 - resp) * loss_noobj
                    + resp * loss_cls)
        return per_cell.sum((1, 2, 3))


@dataclasses.dataclass
class DetectedObject:
    """One decoded detection (org.deeplearning4j.nn.layers.objdetect
    .DetectedObject); center and size in grid units."""

    center_x: float
    center_y: float
    width: float
    height: float
    confidence: float
    class_index: int
    class_probs: np.ndarray

    def top_left(self):
        return self.center_x - self.width / 2, self.center_y - self.height / 2

    def bottom_right(self):
        return self.center_x + self.width / 2, self.center_y + self.height / 2


def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def get_predicted_objects(layer: Yolo2OutputLayer, preout,
                          threshold: float = 0.5):
    """YoloUtils.getPredictedObjects: decode and threshold on the host.
    ``preout`` is the network output (a tensor on any device, or an
    array); returns one list of DetectedObject an image, in (i, j, anchor)
    order."""
    A, C = len(layer.anchors), layer.n_classes
    if isinstance(preout, torch.Tensor):
        preout = preout.detach().float().cpu().numpy()
    p = np.asarray(preout, np.float32)
    Bn, H, W, _ = p.shape
    p = p.reshape(Bn, H, W, A, 5 + C)
    pri = np.asarray(layer.anchors, np.float32)
    conf = _sig(p[..., 4])
    b_idx, i_idx, j_idx, a_idx = np.nonzero(~(conf < threshold))
    sel = p[b_idx, i_idx, j_idx, a_idx]                # [N, 5 + C]
    cx = j_idx.astype(np.float32) + _sig(sel[:, 0])  # f32, as j + f32 is
    cy = i_idx.astype(np.float32) + _sig(sel[:, 1])
    w = pri[a_idx, 0] * np.exp(sel[:, 2])
    h = pri[a_idx, 1] * np.exp(sel[:, 3])
    if C:
        logits = sel[:, 5:]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        cls = probs.argmax(-1)
    out = [[] for _ in range(Bn)]
    for n, b in enumerate(b_idx):
        out[b].append(DetectedObject(
            float(cx[n]), float(cy[n]), float(w[n]), float(h[n]),
            float(conf[b, i_idx[n], j_idx[n], a_idx[n]]),
            int(cls[n]) if C else 0,
            probs[n] if C else np.zeros(0, np.float32)))
    return out


def non_max_suppression(dets, iou_threshold: float = 0.45):
    """YoloUtils.nms over one image's DetectedObject list: by confidence
    (ties keep their order), dropping a box that overlaps a kept box of
    its class by more than ``iou_threshold``."""
    dets = sorted(dets, key=lambda d: -d.confidence)
    keep = []

    def iou(a, b):
        ax1, ay1 = a.top_left()
        ax2, ay2 = a.bottom_right()
        bx1, by1 = b.top_left()
        bx2, by2 = b.bottom_right()
        iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
        ih = max(0.0, min(ay2, by2) - max(ay1, by1))
        inter = iw * ih
        ua = a.width * a.height + b.width * b.height - inter
        return inter / ua if ua > 0 else 0.0

    for d in dets:
        if all(iou(d, k) <= iou_threshold or k.class_index != d.class_index
               for k in keep):
            keep.append(d)
    return keep
