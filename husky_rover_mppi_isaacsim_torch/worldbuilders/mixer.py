"""RequestMixer: executes a bundle of typed randomization requests.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/worldbuilders/mixer.py``
(the re-derivation of ``WorldBuilders/Mixer.py``, reference :9-177):
requests are grouped by USD attribute (translation / scale / orientation),
the single point process (if any) runs first (its output count drives
every other sampler), clippers consume the already-sampled xy positions,
unspecified axes fill with the attribute's default value, and the result is
a dict ``{attribute_name: (N, dim) float64 tensor}`` on the mixer's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import run_device
from . import types as T
from ._tensor import F64
from .clippers import Clipper_Factory
from .layers import Layer_Factory


class MetaLayer:
    """Uniform callable over layers and clippers (Mixer.py:9-20)."""

    def __init__(self, layer_cfg, sampler_cfg, device=None):
        if isinstance(sampler_cfg, T.Clipper_T):
            self.layer = Clipper_Factory.get(sampler_cfg, device=device)
            self.is_clipper = True
        else:
            self.layer = Layer_Factory.get(layer_cfg, sampler_cfg, device=device)
            self.is_clipper = False

    def __call__(self, num=1, query_point=None, parents=(), **kwargs):
        if query_point is not None:
            return self.layer(query_point=query_point, num=num, **kwargs)
        return self.layer(num, parents=parents, **kwargs)


class RequestMixer:
    """Mixer.py:22-177."""

    def __init__(self, requests: tuple, device=None):
        """``device``: where every layer, clipper DEM and result lives
        (default: the card, see :func:`..core.device.run_device`)."""
        self.device = run_device(device)
        self.requests = requests
        self.has_point_process = False
        self.point_process_inherits_parents = False
        self.point_process_attr = None
        self.height_clip_pos = None    # (attribute, index) of the height clipper
        self.orient_clip_pos = None
        self._parse_requests()
        self._build_execution_graph()

    def __call__(self, num=1, parents=()):
        return self.execute_graph(num=num, parents=parents)

    def get_parents(self):
        """Parent coordinates of the point process, for coupled mixers
        (Mixer.py:34-42)."""
        if self.point_process_attr is None:
            return []
        meta = self.execution_graph[self.point_process_attr]["meta_layer"][0]
        return meta.layer._sampler.parents_coords

    def _parse_requests(self):
        requests_per_type = {}
        for req in self.requests:
            requests_per_type.setdefault(req.p_type.name, []).append(req)

        point_processes = 0
        for key, reqs in requests_per_type.items():
            axes = []
            for i, req in enumerate(reqs):
                if isinstance(req.sampler, T.PointProcess_T):
                    point_processes += 1
                    assert point_processes <= 1, "There can only be one point process."
                    self.has_point_process = True
                    self.point_process_attr = req.p_type.attribute_name
                    if getattr(req.sampler, "inherit_parents", False):
                        self.point_process_inherits_parents = True
                if isinstance(req.sampler, T.ImageClipper_T):
                    self.height_clip_pos = (req.p_type.attribute_name, i)
                if isinstance(req.sampler, T.NormalMapClipper_T):
                    self.orient_clip_pos = (req.p_type.attribute_name, i)
                for axis in "".join(req.axes):
                    axes.append(axis)
                assert len(req.axes) == req.layer.output_space, (
                    f"{key}: layer dimension does not match the number of axes"
                )
            assert len(np.unique(axes)) == len(axes), f"{key}: duplicate axes"
        self.requests_per_type = requests_per_type

    def _build_execution_graph(self):
        self.execution_graph = {}
        for req_type, reqs in self.requests_per_type.items():
            attribute_name = reqs[0].p_type.attribute_name
            to_exec = {"meta_layer": [], "replicate": [], "order": [], "axes": []}
            specified_axes = []
            for req in reqs:
                to_exec["meta_layer"].append(MetaLayer(req.layer, req.sampler, self.device))
                to_exec["replicate"].append(
                    np.repeat(list(range(len(req.axes))), [len(a) for a in req.axes]).tolist()
                )
                to_exec["order"].append(
                    [req.p_type.index_mapping[axis] for axis in "".join(req.axes)]
                )
                to_exec["axes"].append(list(range(len(to_exec["replicate"][-1]))))
                specified_axes.append(req.axes)
            specified = "".join(a for sub in specified_axes for a in sub)
            p_type = reqs[0].p_type
            for axis in p_type.components:
                if axis not in specified:
                    idx = p_type.index_mapping[axis]
                    value = float(p_type.default_value[idx])
                    to_exec["meta_layer"].append(
                        lambda x, value=value: torch.full((x, 1), value, dtype=F64,
                                                          device=self.device)
                    )
                    to_exec["replicate"].append([0])
                    to_exec["order"].append([idx])
                    to_exec["axes"].append([0])
            self.execution_graph[attribute_name] = to_exec

    def execute_graph(self, num=1, parents=()):
        output = {}
        attributes = list(self.execution_graph.keys())
        if self.point_process_attr is not None:
            attributes = [self.point_process_attr] + [
                a for a in attributes if a != self.point_process_attr
            ]
        is_first = True
        query_points = None
        points = None
        for attribute in attributes:
            to_exec = self.execution_graph[attribute]
            current_order = []
            p_list = []
            for j, meta in enumerate(to_exec["meta_layer"]):
                is_height_clip = self.height_clip_pos == (attribute, j)
                is_orient_clip = self.orient_clip_pos == (attribute, j)
                if is_height_clip:
                    assert points is not None and points.shape[-1] == 2, (
                        "height clip must follow a 2D position sample"
                    )
                    query_points = points.clone()
                    points = meta(query_point=query_points, num=num)
                elif is_orient_clip:
                    assert query_points is not None, (
                        "orientation clip must follow a 2D position sample"
                    )
                    points = meta(query_point=query_points, num=num)
                else:
                    if callable(meta) and not isinstance(meta, MetaLayer):
                        points = meta(num)
                    elif (self.has_point_process and is_first
                          and self.point_process_inherits_parents):
                        points = meta(num, parents=parents)
                    else:
                        points = meta(num)
                    if self.has_point_process and is_first and isinstance(meta, MetaLayer):
                        # reference semantics (Mixer.py:169-171): num
                        # latches from the FIRST meta layer of the
                        # point-process attribute; if a request tuple puts
                        # another sampler before the point process on the
                        # same attribute, upstream latches the wrong count
                        # too: order the point-process request first
                        num = points.shape[0]
                        is_first = False
                points = points[:, to_exec["replicate"][j]].to(F64)
                current_order += to_exec["order"][j]
                p_list.append(points)
            points = torch.cat(p_list, dim=-1)
            remapped = [current_order.index(i) for i in range(len(current_order))]
            points = points[:, remapped]
            output[attribute] = points
        return output
