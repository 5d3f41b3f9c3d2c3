"""The spatial-tile context-parallel VAE decode over a ``seq`` ring
(counterpart of ``s2v_tpu/parallel/vae_spatial.py``: ``spatial_cp_supported``
:42, ``spatial_tiled_decode_cp`` :58).

Above its native resolution the decode tiles each frame into overlapping
tiles that decode independently (``models/vae.py::_tiled``), so the tiles
spread over the ring with no communication until the end:

  * the full-size interior tiles, the bulk of the grid, are dealt to the
    ranks in order, each rank decoding a contiguous run of them; the list
    is padded to a multiple of the ring with copies of its first tiles, and
    the copies' outputs are dropped;
  * the ragged edge tiles (the grid's ``range(0, h, overlap)`` overshoots
    the frame) decode at their true sizes on every rank, as JAX's does:
    padding them would change the convolutions' border values;
  * every rank gathers the interior tiles and blends all of them with the
    single-card tiled decode's own blend, so every rank returns the whole
    clip, equal to ``vae_decode(..., use_tiling=True)``'s.

Latents come in whole on every rank, channels-last as ``models/vae.py``'s.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from s2v_torch.config import VAEConfig
from s2v_torch.models.vae import _decode_plain, blend_h, blend_v
from s2v_torch.parallel.context import all_gather_rows


def _grid(cfg: VAEConfig, height: int, width: int):
    th, tw = cfg.tile_latent_min_height, cfg.tile_latent_min_width
    overlap_h = int(th * (1 - cfg.tile_overlap_factor_height))
    overlap_w = int(tw * (1 - cfg.tile_overlap_factor_width))
    return list(range(0, height, overlap_h)), list(range(0, width, overlap_w)), th, tw


def _split(cfg: VAEConfig, height: int, width: int) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(full, edge) tile positions in the grid's row-major order."""
    rows, cols, th, tw = _grid(cfg, height, width)
    full, edge = [], []
    for i in rows:
        for j in cols:
            (full if i + th <= height and j + tw <= width else edge).append((i, j))
    return full, edge


def _ring(mesh, axis: str):
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def spatial_cp_supported(cfg: VAEConfig, z: torch.Tensor, mesh, axis: str = "seq") -> bool:
    """Whether the decode of the latents ``z`` ``[B, T, h, w, C]`` tiles and
    has at least one full tile for each rank of the mesh's ``axis``."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return False
    if not (z.shape[2] > cfg.tile_latent_min_height or z.shape[3] > cfg.tile_latent_min_width):
        return False  # the untiled regime
    full, _ = _split(cfg, z.shape[2], z.shape[3])
    return len(full) >= _ring(mesh, axis)[1]


def spatial_tiled_decode_cp(params: dict, cfg: VAEConfig, z: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """The tiled decode of ``z`` ``[B, T, h, w, C]`` with its full tiles
    spread over ``mesh[axis]``: pixels ``[B, T', H, W, 3]`` on every rank,
    the same tiles, ragged edges and blend as the single-card tiled
    decode.  Raises when the ring has more ranks than full tiles."""
    group, ring, rank = _ring(mesh, axis)
    height, width = z.shape[2], z.shape[3]
    rows, cols, th, tw = _grid(cfg, height, width)
    full, edge = _split(cfg, height, width)
    if len(full) < ring:
        raise ValueError(f"spatial CP needs >= {ring} full tiles (have {len(full)}); use the sequential tiled "
                         f"decode")
    zc = z.permute(0, 4, 1, 2, 3)  # channels-first, as the decoder takes it

    def decode(pos):
        i, j = pos
        return _decode_plain(params, cfg, zc[:, :, :, i:i + th, j:j + tw])

    # the interior: this rank's run of the padded list, gathered in order
    padded = full + full[:(-len(full)) % ring]
    per = len(padded) // ring
    mine = torch.stack([decode(pos) for pos in padded[rank * per:(rank + 1) * per]])
    gathered = all_gather_rows(mine, group, ring, dim=0)
    tiles = {pos: gathered[n] for n, pos in enumerate(full)}
    for pos in edge:
        tiles[pos] = decode(pos)

    # the single-card blend (models/vae.py::_tiled)
    tile_out_h, tile_out_w = cfg.tile_sample_min_height, cfg.tile_sample_min_width
    blend_e_h = int(tile_out_h * cfg.tile_overlap_factor_height)
    blend_e_w = int(tile_out_w * cfg.tile_overlap_factor_width)
    limit_h, limit_w = tile_out_h - blend_e_h, tile_out_w - blend_e_w
    grid = [[tiles[(i, j)] for j in cols] for i in rows]
    result_rows = []
    for i, row in enumerate(grid):
        result_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend_v(grid[i - 1][j], tile, blend_e_h)
            if j > 0:
                tile = blend_h(row[j - 1], tile, blend_e_w)
            result_row.append(tile[:, :, :, :limit_h, :limit_w])
        result_rows.append(torch.cat(result_row, dim=4))
    return torch.cat(result_rows, dim=3).permute(0, 2, 3, 4, 1)


__all__ = ["spatial_cp_supported", "spatial_tiled_decode_cp"]
