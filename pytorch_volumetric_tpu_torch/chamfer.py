"""Chamfer-distance metrics and the plausible-diversity set divergence.

Unidirectional chamfer distance (world-frame points -> the object posed by
a batch of transforms, through an SDF or the exact closest point),
pose-space pairwise distances, and the plausibility / coverage divergence
between an estimated and a plausible set of poses.  The pairwise pose
composition is one einsum and everything downstream is one batched query
over all poses x points, which the exact branch sends through the
closest-point kernel (``ObjectFactory.object_frame_closest_point``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pytorch_volumetric_tpu_torch import transforms as tfm
from pytorch_volumetric_tpu_torch.sdf import (
    ObjectFactory, ObjectFrameSDF, sample_mesh_points,
)
from pytorch_volumetric_tpu_torch.utils.batching import as_float_tensor


def pairwise_distance(world_to_link_tfs: tfm.Transform3d) -> torch.Tensor:
    """Pose-space pairwise distance: Euclidean distance between
    (translation, 6D rotation) vectors, ``[B, B]``."""
    m = world_to_link_tfs.get_matrix()
    t = m[:, :3, 3]
    r = tfm.matrix_to_rotation_6d(m[:, :3, :3])
    cont_rep = torch.cat((t, r), dim=1)
    diff = cont_rep[:, None, :] - cont_rep[None, :, :]
    return torch.linalg.vector_norm(diff, dim=-1)


def batch_chamfer_dist(world_to_object, model_points_world_frame_eval,
                       obj_factory: Optional[ObjectFactory] = None,
                       obj_sdf: Optional[ObjectFrameSDF] = None,
                       viewing_delay=0, scale=1000.0, print_err=False, vis=None):
    """Batched unidirectional chamfer distance between observed world-frame
    surface points ``[N, 3]`` and the object posed by ``B`` world -> object
    transforms ``[B, 4, 4]``, on the device of ``obj_sdf`` (else
    ``obj_factory``).  ``viewing_delay``, ``print_err`` and ``vis`` are
    accepted for API compatibility; there is no visualisation.

    :return: ``[B]`` mean of ``(scale * d)^2`` over the N points.
    """
    del viewing_delay, print_err, vis
    owner = obj_sdf if obj_sdf is not None else obj_factory
    if owner is None:
        raise ValueError("Either obj_sdf or obj_factory must be given")
    world_to_object = as_float_tensor(world_to_object, owner.device)
    pts = as_float_tensor(model_points_world_frame_eval, owner.device)
    model_points_object_frame_eval = tfm.transform_points(world_to_object, pts)

    if obj_sdf is not None:
        d, _ = obj_sdf(model_points_object_frame_eval)
    else:
        d = obj_factory.object_frame_closest_point(model_points_object_frame_eval).distance
    chamfer_distance = (scale * d) ** 2
    return chamfer_distance.mean(dim=-1)


def pairwise_distance_chamfer(A_link_to_world_tfs: tfm.Transform3d,
                              B_world_to_link_tfs: Optional[tfm.Transform3d] = None,
                              obj_factory: Optional[ObjectFactory] = None,
                              obj_sdf: Optional[ObjectFrameSDF] = None,
                              model_points_eval=None, vis=None, scale=1000):
    """``[B, P]`` pairwise chamfer between two transform sets: one einsum
    composes every pair of poses, then one flattened batched chamfer."""
    if model_points_eval is None:
        model_points_eval, _, _ = sample_mesh_points(
            obj_factory, num_points=500, name=obj_factory.name)

    T = A_link_to_world_tfs.get_matrix()
    if B_world_to_link_tfs is None:
        T_inv = A_link_to_world_tfs.inverse().get_matrix()
    else:
        T_inv = B_world_to_link_tfs.get_matrix()
    Iapprox = tfm.precise_einsum("bij,pjk->bpik", T_inv, T)

    B = T_inv.shape[0]
    P = T.shape[0]
    errors_per_batch = batch_chamfer_dist(
        Iapprox.reshape(B * P, 4, 4), model_points_eval,
        obj_factory=obj_factory, obj_sdf=obj_sdf, scale=scale, vis=vis)
    return errors_per_batch.reshape(B, P)


class PlausibleDiversityReturn(NamedTuple):
    plausibility: torch.Tensor
    coverage: torch.Tensor
    most_plausible_per_estimated: tuple
    most_covered_per_plausible: tuple


class PlausibleDiversity:
    """Set divergence between an estimated and a plausible set of poses:
    plausibility is the mean over estimated poses of the row minimum of the
    pairwise chamfer matrix, coverage the mean over plausible poses of the
    column minimum."""

    def __init__(self, obj_factory: ObjectFactory, model_points_eval=None,
                 num_model_points_eval=500, obj_sdf: Optional[ObjectFrameSDF] = None):
        self.obj_factory = obj_factory
        self.obj_sdf = obj_sdf
        if model_points_eval is None:
            model_points_eval, _, _ = sample_mesh_points(
                obj_factory, num_points=num_model_points_eval, name=obj_factory.name)
        self.model_points_eval = model_points_eval

    def __call__(self, T_est_inv, T_p, bidirectional=False, scale=1000.0):
        errors_per_batch = self.compute_tf_pairwise_error_per_batch(
            T_est_inv, T_p, scale=scale)
        ret = self.do_evaluate_plausible_diversity_on_pairwise_chamfer_dist(
            errors_per_batch)
        if bidirectional:
            errors_rev = self.compute_tf_pairwise_error_per_batch(
                T_p, T_est_inv, scale=scale)
            ret2 = self.do_evaluate_plausible_diversity_on_pairwise_chamfer_dist(
                errors_rev)
            ret = PlausibleDiversityReturn(
                plausibility=(ret.plausibility + ret2.coverage) / 2,
                coverage=(ret.coverage + ret2.plausibility) / 2,
                most_plausible_per_estimated=ret.most_plausible_per_estimated,
                most_covered_per_plausible=ret.most_covered_per_plausible,
            )
        return ret

    def compute_tf_pairwise_error_per_batch(self, T_est_inv, T_p, scale=1000.0):
        owner = self.obj_sdf if self.obj_sdf is not None else self.obj_factory
        device = owner.device
        T_est_inv = as_float_tensor(T_est_inv, device)
        T_p = as_float_tensor(T_p, device)
        Iapprox = tfm.precise_einsum("bij,pjk->bpik", T_est_inv, T_p)
        B, P = Iapprox.shape[:2]
        errors_per_batch = batch_chamfer_dist(
            Iapprox.reshape(B * P, 4, 4), self.model_points_eval,
            self.obj_factory, obj_sdf=self.obj_sdf, scale=scale)
        return errors_per_batch.reshape(B, P)

    @staticmethod
    def do_evaluate_plausible_diversity_on_pairwise_chamfer_dist(errors_per_batch):
        B, P = errors_per_batch.shape
        best_per_sampled_val, best_per_sampled_idx = errors_per_batch.min(dim=1)
        best_per_plausible_val, best_per_plausible_idx = errors_per_batch.min(dim=0)

        bp_plausibility = best_per_sampled_val.sum() / B
        bp_coverage = best_per_plausible_val.sum() / P
        return PlausibleDiversityReturn(
            bp_plausibility, bp_coverage,
            (best_per_sampled_val, best_per_sampled_idx),
            (best_per_plausible_val, best_per_plausible_idx))
