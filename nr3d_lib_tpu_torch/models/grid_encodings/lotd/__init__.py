from nr3d_lib_tpu_torch.models.grid_encodings.lotd.lotd_brick_encoding import LoTDBrickEncoding  # noqa: F401,E501


def get_lotd_encoding(input_ch: int = 3, *, backend: str = "xla",
                      lotd_cfg=None, hashmap_rows: int = 4096, seed: int = 0,
                      device=None):
    """Encoding factory shared by the field classes. Only the 'brick'
    backend is ported; `lotd_cfg.hashmap_size` is ignored on it (the hash
    capacity is `hashmap_rows` brick rows), as in the JAX package."""
    if backend != "brick":
        raise NotImplementedError(
            f"LoTD backend {backend!r} is not ported yet (ROADMAP.md A9)")
    lc = dict(lotd_cfg or {})
    types = lc.get("lod_types", "Dense")
    if isinstance(types, str):
        types = [types] * len(lc["lod_res"])
    return LoTDBrickEncoding(input_ch, lod_res=lc["lod_res"], lod_types=types,
                             hashmap_rows=hashmap_rows,
                             n_feats=int(lc.get("lod_n_feats", 2)),
                             seed=seed, device=device)
