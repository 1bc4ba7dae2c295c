"""The reference SMIRK system: the serving path and the two-path training
step in plain PyTorch (from smirk_tpu_torch/train/trainer.py at commit
19e99aba3b04, one process, fp32 unless the caller turns TF32 on).

infer: encoders (eval) -> FLAME -> the inference render.
train_step: path 1 (encoders in train mode -> FLAME -> the differentiable
render -> landmark and regularization losses, with the generator the
masked reconstruction, L1 and VGG perceptual losses, with MICA its shape
loss), one backward, the encoder's and the generator's Adam steps; then,
with the generator and a cycle weight, the cycle path (augmented
parameters rendered without gradient, the generator on the render and the
masked hints, the re-encode, the cycle loss) and the unfrozen module's
Adam step (the generator's clipped to a global norm of 0.1). Every random
draw is given (`draws`), as the benchmark hands the program the same.

Adam is written out (m, v, bias corrections, eps added to the corrected
square root); the learning rates follow the program's cosine schedule
restarted every epoch.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping

import numpy as np
import torch

from benchmark.reference import geometry, masking
from benchmark.reference.encoders import SmirkEncoder
from benchmark.reference.flame import FlameModel
from benchmark.reference.generator import SmirkGenerator
from benchmark.reference.losses import landmark_mse, masked_landmark_mse, param_regularization
from benchmark.reference.mica import Mica
from benchmark.reference.mobilenetv3 import ARCHS
from benchmark.reference.render import Renderer
from benchmark.reference.vgg import VGG16Features, perceptual_loss

SUB_ENCODERS = ("pose_encoder", "shape_encoder", "expression_encoder")
RANDOM_MASK, CYCLE_RANDOM_MASK = 0.01, 0.005


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN convolutions and CUDA matmuls in TF32 or in exact fp32 within
    the block; the flags are restored on exit."""
    b = torch.backends
    saved = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved


def cosine_lr(peak: float, steps_per_epoch: int, step: int) -> float:
    eta_min = 0.01 * peak
    t = step % steps_per_epoch
    return eta_min + (peak - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t / steps_per_epoch))


class Adam:
    def __init__(self, params, b1: float, b2: float, eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads, lr: float):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + self.eps))


def clip_global(grads, max_norm: float):
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
    return [g * scale for g in grads]


class ReferenceSystem:
    """cfg: the configuration file's dict; weights: {module name: state
    dict}, the same the program is given; bundle: the FLAME head."""

    def __init__(self, cfg: Mapping, bundle: Dict[str, np.ndarray], weights: Mapping,
                 device, steps_per_epoch: int):
        arch, train = cfg["arch"], cfg["train"]
        self.cfg, self.device = cfg, device
        self.S = cfg["image_size"]
        self.weights_ = train["loss_weights"]
        self.steps_per_epoch = steps_per_epoch
        with torch.device(device):
            self.encoder = SmirkEncoder(
                n_exp=arch["num_expression"], n_shape=arch["num_shape"],
                pose_stages=ARCHS[arch["backbone_pose"]],
                shape_stages=ARCHS[arch["backbone_shape"]],
                expression_stages=ARCHS[arch["backbone_expression"]])
            self.generator = (SmirkGenerator(6, 3, cfg["generator_features"],
                                             cfg["generator_res_blocks"])
                              if arch["enable_fuse_generator"] else None)
        self.encoder.load_state_dict(weights["encoder"])
        if self.generator is not None:
            self.generator.load_state_dict(weights["generator"])
        self.vgg = self._teacher(VGG16Features, weights.get("vgg"))
        self.mica = self._teacher(Mica, weights.get("mica"))
        self.flame = FlameModel(bundle, n_shape=arch["num_shape"],
                                n_exp=arch["num_expression"], device=device)
        self.renderer = Renderer(bundle, self.S, device)
        self.face_probabilities = torch.as_tensor(bundle["face_probabilities"],
                                                  dtype=torch.float32, device=device)
        faces = np.asarray(bundle["faces"])
        fidx, cidx = geometry.build_vertex_face_incidence(faces, int(faces.max()) + 1)
        self.incidence = (torch.as_tensor(fidx, dtype=torch.long, device=device),
                          torch.as_tensor(cidx, dtype=torch.long, device=device))
        self.templates = torch.zeros((1, arch["num_expression"]), device=device)
        self.num_mask_points = int(train["mask_ratio"] * self.S ** 2)
        flags = {"pose_encoder": train["optimize_pose"], "shape_encoder": train["optimize_shape"],
                 "expression_encoder": train["optimize_expression"]}
        for name in SUB_ENCODERS:
            getattr(self.encoder, name).requires_grad_(flags[name])
        self.enc_named = [(f"{name}.{n}", p) for name in SUB_ENCODERS if flags[name]
                          for n, p in getattr(self.encoder, name).named_parameters()]
        self.gen_named = ([] if self.generator is None
                          else list(self.generator.named_parameters()))
        self.enc_opt = Adam([p for _, p in self.enc_named], 0.9, 0.999)
        self.gen_opt = Adam([p for _, p in self.gen_named], 0.5, 0.999)
        self.step = 0

    def _teacher(self, cls, state):
        if state is None:
            return None
        with torch.device(self.device):
            module = cls()
        module.load_state_dict(state)
        return module.eval().requires_grad_(False)

    def _lr(self, scale: float) -> float:
        return cosine_lr(scale * self.cfg["train"]["lr"], self.steps_per_epoch, self.step)

    # ------------------------------- serving -------------------------------

    @torch.no_grad()
    def infer(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.encoder.eval()
        enc = self.encoder(img)
        fl = self.flame(enc)
        rend = self.renderer(fl["vertices"], enc["cam"],
                             {"landmarks_fan": fl["landmarks_fan"],
                              "landmarks_mp": fl["landmarks_mp"]}, inference=True)
        return {**enc, **fl, **rend}

    # ------------------------------- path 1 --------------------------------

    def loss1(self, batch, draws):
        w = self.weights_
        img = batch["img"]
        B = img.shape[0]
        zero = img.new_zeros(())
        self.encoder.train()
        enc = self.encoder(img)
        fl = self.flame(enc)
        rend = self.renderer(fl["vertices"], enc["cam"],
                             {"landmarks_fan": fl["landmarks_fan"],
                              "landmarks_mp": fl["landmarks_mp"]},
                             inference=self.generator is None)
        L = {"landmark_loss_fan": masked_landmark_mse(
                 rend["landmarks_fan"], batch["landmarks_fan"][..., :2],
                 batch["flag_landmarks_fan"]),
             "landmark_loss_mp": landmark_mse(rend["landmarks_mp"],
                                              batch["landmarks_mp"][..., :2])}
        base = {"expression": img.new_zeros((B, self.encoder.n_exp)),
                "shape": img.new_zeros((B, enc["shape_params"].shape[1])),
                "jaw": img.new_zeros((B, 3))}
        for k in ("expression", "shape", "jaw"):
            L[f"{k}_regularization"] = param_regularization(enc[f"{k}_params"], base[k])
        L["reconstruction_loss"] = L["perceptual_vgg_loss"] = L["mica_loss"] = zero
        if self.generator is not None:
            npoints, _ = masking.sample_mesh_points(
                rend["transformed_vertices"].detach(), self.flame.faces,
                self.face_probabilities, self.num_mask_points, self.S,
                incidence=self.incidence, u=draws["u"], bary=draws["bary"])
            extra = masking.transfer_pixels(img, npoints, npoints)
            masked = masking.compose_mask(
                img, batch["mask"], extra,
                dilation_radius=self.cfg["train"]["mask_dilation_radius"],
                rendered_mask=rend["rendered_mask"], random_mask=RANDOM_MASK,
                noise=draws["noise"], drop_centers=draws["drop_centers"])
            self.generator.train()
            recon = self.generator(torch.cat([rend["rendered_img"], masked], -1))
            L["reconstruction_loss"] = (recon - img).abs().mean()
            if self.vgg is not None and w["perceptual_vgg_loss"] > 0:
                L["perceptual_vgg_loss"] = perceptual_loss(self.vgg, recon, img)
        if self.mica is not None and w["mica_loss"] > 0:
            with torch.no_grad():
                mica_shape = self.mica(batch["img_mica"])[..., :enc["shape_params"].shape[1]]
            L["mica_loss"] = ((enc["shape_params"] - mica_shape) ** 2).mean()
        t = self.cfg["train"]
        total = (L["landmark_loss_fan"] + L["landmark_loss_mp"]) * w["landmark_loss"]
        if t["optimize_shape"]:
            total = total + (L["shape_regularization"] * w["shape_regularization"]
                             + L["mica_loss"] * w["mica_loss"])
        if t["optimize_expression"]:
            total = total + (L["expression_regularization"] * w["expression_regularization"]
                             + L["jaw_regularization"] * w["jaw_regularization"])
        if self.generator is not None:
            total = total + (L["perceptual_vgg_loss"] * w["perceptual_vgg_loss"]
                             + L["reconstruction_loss"] * w["reconstruction_loss"])
        return total, enc, rend

    # ------------------------------- path 2 --------------------------------

    def augment(self, feats, d):
        expr = feats["expression_params"].clone()
        n = expr.shape[0]
        q = n // 4
        eyelid = feats["eyelid_params"]
        perm = d["perm"].long()
        g0, g1, g2, g3 = perm[:q], perm[q:2 * q], perm[2 * q:3 * q], perm[3 * q:]
        new0 = d["noise0"] * (1 + 2 * d["scale0"]) * d["pm"] + expr[g0]
        expr[g0] = new0.clamp(-4.0, 4.0) + 0.2 * d["jitter_scale0"] * d["jitter0"]
        expr[g1] = ((0.25 + 1.25 * d["scale1"]) * expr[g1][d["inner"].long()]
                    + 0.2 * d["jitter_scale1"] * d["jitter1"])
        expr[g2] = ((0.25 + 1.25 * d["scale2"]) * self.templates[d["tidx"].long()]
                    + 0.2 * d["jitter_scale2"] * d["jitter2"])
        jaw = feats["jaw_params"] + d["jaw_noise"] * 0.2 * (
            expr.new_tensor([[1.0, 0.1, 0.1]]) * d["jaw_mask"])
        jaw = torch.cat([jaw[:, :1].clamp(0.0, 0.5), jaw[:, 1:]], 1)
        use_eyelids = self.cfg["arch"]["use_eyelids"]
        if use_eyelids:
            eyelid = (eyelid + (-1 + 2 * d["eyelid_u"]) * 0.25).clamp(0.0, 1.0)
        expr[g3] = 0.2 * d["jitter_scale3"] * d["jitter3"]
        jaw[g3] = 0.0
        if use_eyelids:
            eyelid = eyelid.clone()
            eyelid[g3] = d["eyelid3"]
        out = dict(feats, expression_params=expr, jaw_params=jaw, eyelid_params=eyelid)
        return {k: v.detach() for k, v in out.items()}

    def loss2(self, batch, enc, trans_verts, freeze_encoder: bool, draws):
        img = batch["img"]
        Ke = self.cfg["train"]["Ke"]
        feats = {k: torch.cat([v.detach()] * Ke, 0) for k, v in enc.items()}
        feats = self.augment(feats, draws["augment"])
        with torch.no_grad():
            fl2 = self.flame(feats)
            rend2 = self.renderer(fl2["vertices"], feats["cam"], inference=True)
        points1, coords = masking.sample_mesh_points(
            trans_verts, self.flame.faces, self.face_probabilities, self.num_mask_points,
            self.S, incidence=self.incidence, u=draws["u"], bary=draws["bary"])
        coords = {k: torch.cat([v] * Ke, 0) for k, v in coords.items()}
        points2, _ = masking.sample_mesh_points(
            rend2["transformed_vertices"], self.flame.faces, self.face_probabilities,
            self.num_mask_points, self.S, coords=coords)
        img_k = torch.cat([img] * Ke, 0)
        extra = masking.transfer_pixels(img_k, torch.cat([points1] * Ke, 0), points2)
        masked2 = masking.compose_mask(
            img_k, torch.cat([batch["mask"]] * Ke, 0), extra,
            dilation_radius=self.cfg["train"]["mask_dilation_radius"],
            rendered_mask=rend2["rendered_mask"], extra_noise=True,
            random_mask=CYCLE_RANDOM_MASK, noise=draws["noise"],
            drop_centers=draws["drop_centers"])
        gen_in = torch.cat([rend2["rendered_img"], masked2], -1).detach()
        if freeze_encoder:  # the generator trains; the gradient flows through the encoder
            self.generator.train()
            recon = self.generator(gen_in)
            self.encoder.eval()
            params = [p for p in self.encoder.parameters() if p.requires_grad]
            for p in params:
                p.requires_grad_(False)
            try:
                rf = self.encoder(recon)
            finally:
                for p in params:
                    p.requires_grad_(True)
        else:  # the encoder trains on the frozen generator's output
            self.generator.eval()
            with torch.no_grad():
                recon = self.generator(gen_in)
            self.encoder.train()
            rf = self.encoder(recon)
        cycle = (landmark_mse(rf["expression_params"], feats["expression_params"])
                 + 10.0 * landmark_mse(rf["jaw_params"], feats["jaw_params"]))
        if self.cfg["arch"]["use_eyelids"]:
            cycle = cycle + 10.0 * landmark_mse(rf["eyelid_params"], feats["eyelid_params"])
        if freeze_encoder:
            cycle = cycle + landmark_mse(rf["shape_params"], feats["shape_params"])
        return cycle * self.weights_["cycle_loss"], rend2

    # ------------------------------ full step ------------------------------

    @staticmethod
    def _grads(total, named):
        params = [p for _, p in named]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def train_step(self, batch, parity: int, draws) -> Dict[str, object]:
        """-> {"losses": [path 1's, and path 2's with the cycle], "grads":
        {leaf: path 1's gradient} (what the optimizers get first),
        "face_verts": the rasterized faces of each render, "coverage": the
        share of path 1's pixels the render covers}."""
        loss1, enc, rend = self.loss1(batch, draws["path1"])
        grads = self._grads(loss1, self.enc_named + self.gen_named)
        n = len(self.enc_named)
        out = {"losses": [float(loss1.detach())], "face_verts": [rend["face_verts"]],
               "coverage": float(rend["rendered_mask"].mean()),
               "grads": {name: g for (name, _), g in
                         zip(self.enc_named + self.gen_named, grads)}}
        self.enc_opt.step(grads[:n], self._lr(0.25))
        if self.generator is not None:
            self.gen_opt.step(grads[n:], self._lr(1.0))
        if self.generator is not None and self.weights_["cycle_loss"] > 0:
            freeze_encoder = parity % 2 == 0
            loss2, rend2 = self.loss2(batch, {k: v.detach() for k, v in enc.items()},
                                      rend["transformed_vertices"].detach(),
                                      freeze_encoder, draws["path2"])
            if freeze_encoder:
                self.gen_opt.step(clip_global(self._grads(loss2, self.gen_named), 0.1),
                                  self._lr(1.0))
            else:
                self.enc_opt.step(self._grads(loss2, self.enc_named), self._lr(0.25))
            out["losses"].append(float(loss2.detach()))
            out["face_verts"].append(rend2["face_verts"])
        self.encoder.eval()
        if self.generator is not None:
            self.generator.eval()
        self.step += 1
        return out

    def trained(self) -> Dict[str, torch.Tensor]:
        return {name: p.detach() for name, p in self.enc_named + self.gen_named}
