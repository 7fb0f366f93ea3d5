from nr3d_lib_tpu_torch.ops.lotd import (  # noqa: F401
    LoDMeta, LoDType, generate_meta, lotd_encode, lotd_fwd_dydx,
    lotd_bwd_dydx)
from nr3d_lib_tpu_torch.models.grid_encodings.lotd.lotd_encoding import LoTDEncoding  # noqa: F401,E501
from nr3d_lib_tpu_torch.models.grid_encodings.lotd.lotd_cfg import (  # noqa: F401,E501
    get_lotd_cfg, auto_ngp_cfg)
from nr3d_lib_tpu_torch.models.grid_encodings.lotd.lotd_brick_encoding import LoTDBrickEncoding  # noqa: F401,E501


def get_lotd_encoding(input_ch: int = 3, *, backend: str = "xla",
                      lotd_cfg=None, hashmap_rows: int = 4096, seed: int = 0,
                      device=None, **kwargs):
    """Encoding factory shared by the field classes, as the JAX package's:
    backend 'brick' → `LoTDBrickEncoding` (Dense/Hash levels on the
    port's kernels; `lotd_cfg.hashmap_size` is ignored there, the hash
    capacity is `hashmap_rows` brick rows, and other keys the fields pass
    on, such as `frozen_x`, are ignored); any other backend (the default,
    'xla') → `LoTDEncoding`, the classic encoding in plain PyTorch, with
    `**kwargs` passed on."""
    if backend == "brick":
        lc = dict(lotd_cfg or {})
        types = lc.get("lod_types", "Dense")
        if isinstance(types, str):
            types = [types] * len(lc["lod_res"])
        return LoTDBrickEncoding(input_ch, lod_res=lc["lod_res"],
                                 lod_types=types, hashmap_rows=hashmap_rows,
                                 n_feats=int(lc.get("lod_n_feats", 2)),
                                 seed=seed, device=device)
    return LoTDEncoding(input_ch, lotd_cfg=lotd_cfg, seed=seed,
                        device=device, **kwargs)
