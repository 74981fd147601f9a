"""The "room" map: photo_slam_tpu_torch/tools/bench_room.py::room_scene's
points (tools/bench.py's scene), frozen at commit
b2b746adc8850e97c8bf961cd6f4acbaa347c7b1 and drawn from the run's
torch.Generator on the device: the 8 x 3 x 12 m box's five faces (walls,
floor, ceiling, far wall; the near side open), then two spheres of 30,000
points each (a tenth of n each for n <= 60,000), with colours uniform in
[0, 1) as room_scene's."""
from __future__ import annotations

import torch


def _u(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def surface(spec: dict, gen, device):
    """(xyz [n, 3], rgb [n, 3]) of spec["gaussians"] points."""
    n = spec["gaussians"]
    sphere_n = 30_000 if n > 60_000 else n // 10
    m = n - 2 * sphere_n
    per = m // 5
    w, h, d = 8.0, 3.0, 12.0
    faces = []
    for sx in (-w / 2, w / 2):
        faces.append(torch.stack([torch.full((per,), sx, device=device),
                                  _u(gen, per, -h / 2, h / 2, device),
                                  _u(gen, per, 0.2, d, device)], 1))
    for sy in (-h / 2, h / 2):
        faces.append(torch.stack([_u(gen, per, -w / 2, w / 2, device),
                                  torch.full((per,), sy, device=device),
                                  _u(gen, per, 0.2, d, device)], 1))
    rest = m - 4 * per
    faces.append(torch.stack([_u(gen, rest, -w / 2, w / 2, device),
                              _u(gen, rest, -h / 2, h / 2, device),
                              torch.full((rest,), d, device=device)], 1))

    def sphere(c, r):
        v = torch.randn((sphere_n, 3), generator=gen, device=device)
        v = v / torch.linalg.norm(v, dim=1, keepdim=True)
        return torch.tensor(c, device=device) + r * v

    xyz = torch.cat(faces + [sphere((-1.0, -0.7, 4.0), 0.8),
                             sphere((1.5, 0.2, 6.5), 1.1)])
    return xyz, torch.rand((n, 3), generator=gen, device=device)
