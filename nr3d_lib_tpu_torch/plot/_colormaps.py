"""The two colour maps the plots use, as matplotlib's 256-entry lookup
tables (matplotlib 3.10: `turbo`, a ListedColormap, and `coolwarm`, a
LinearSegmentedColormap at N = 256) in uint8: entry i is
`(cmap._lut[i, :3] * 255).astype(np.uint8)`, what JAX's
`(cm.get_cmap(name)(x)[..., :3] * 255).astype(np.uint8)` gives for a
value looked up at entry i. `lookup_u8` looks values up as
`Colormap.__call__` does."""

from __future__ import annotations

import numpy as np

__all__ = ["TABLES", "lookup_u8"]

_TURBO = (
    "30123b31154232184a341b51351e5836215f37236538266c3929723a2c793b2f7f3c3285"
    "3c358b3d37913e3a963f3d9c4040a14043a64145ab4148b0424bb5434eba4350be4353c2"
    "4456c74458cb455bce455ed24560d64563d94666dd4668e0466be3466de64670e84673eb"
    "4675ed4678f0467af2467df4467ff64682f84584f94587fb4589fc448cfd438efd4291fe"
    "4193fe4096fe3f98fe3e9bfe3c9dfd3ba0fc39a2fc38a5fb36a8f934aaf833acf631aff5"
    "2fb1f32db4f12bb6ef2ab9ed28bbeb26bde925c0e623c2e421c4e120c6df1ec9dc1dcbda"
    "1ccdd71bcfd41ad1d219d3cf18d5cc18d7ca17d9c717dac417dcc217debf18e0bd18e1ba"
    "19e3b81ae4b61be5b41de7b11ee8af20e9ac22eba924eca627eda329eea02cef9d2ff09a"
    "32f19735f39438f4913bf48d3ff58a42f68746f7834af8804df97c51f97955fa7659fb72"
    "5dfb6f61fc6c65fc6869fd656dfd6271fd5f74fe5c78fe597cfe5680fe5384fe5087fe4d"
    "8bfe4b8efe4892fe4695fe4498fe429bfd409efd3ea1fc3da4fc3ba6fb3aa9fb39acfa37"
    "aef937b1f836b3f835b6f735b9f534bbf434bef334c0f233c3f133c5ef33c8ee33caed33"
    "cdeb34cfea34d1e834d4e735d6e535d8e335dae236dde036dfde36e1dc37e3da37e5d838"
    "e7d738e8d538ead339ecd139edcf39efcd39f0cb3af2c83af3c63af4c43af6c23af7c039"
    "f8be39f9bc39f9ba38fab737fbb537fbb336fcb035fcae34fdab33fda932fda631fda330"
    "fea12ffe9e2efe9b2dfe982cfd952bfd9229fd8f28fd8c27fc8926fc8624fb8323fb8022"
    "fa7d20fa7a1ff9771ef8741cf7711bf76e1af66b18f56817f46516f36315f26014f15d13"
    "ef5a11ee5810ed550fec520eea500de94d0de84b0ce6490be5460ae3440ae24209e04008"
    "de3e08dd3c07db3a07d93806d73606d63405d43205d23005d02f04ce2d04cb2b03c92903"
    "c72803c52602c32402c02302be2102bb1f01b91e01b61c01b41b01b11901ae1801ac1601"
    "a91501a61401a31201a011019d10019a0e01970d01940c01910b018e0a018b0901870801"
    "8407018106027d05027a0402")
_COOLWARM = (
    "3a4cc03b4dc13c4fc33e51c43f53c64054c74156c94258ca435acc455bcd465dcf475fd0"
    "4860d14962d34b64d44c66d64d67d74e69d8506bda516cdb526edc5370dd5571de5673e0"
    "5775e15876e25a78e35b79e45c7be55d7de65f7ee76080e86182ea6383ea6485eb6586ec"
    "6788ed6889ee698bef6b8df06c8ef16d90f16f91f27093f37194f47395f47497f57598f6"
    "779af6789bf77a9df87b9ef87ca0f97ea1f97fa2fa80a4fa82a5fb83a6fb85a8fb86a9fc"
    "87aafc89acfc8aadfd8baefd8daffd8eb1fd90b2fe91b3fe92b4fe94b5fe95b7fe97b8fe"
    "98b9fe99bafe9bbbfe9cbcfe9dbdfe9fbefea0bffea2c0fea3c1fea4c2fea6c3fda7c4fd"
    "a8c5fdaac6fdabc7fcacc8fcaec9fcafcafbb0cbfbb2cbfbb3ccfab4cdfab6cef9b7cff9"
    "b8cff8b9d0f8bbd1f7bcd1f6bdd2f6bed3f5c0d3f5c1d4f4c2d4f3c3d5f2c5d5f2c6d6f1"
    "c7d6f0c8d7efc9d7eecad8eeccd8edcdd9ecced9ebcfd9ead0dae9d1dae8d2dae7d3dbe6"
    "d5dbe5d6dbe4d7dbe2d8dbe1d9dce0dadcdfdbdcdedcdcdddddcdbdedbdadfdbd9e0dad7"
    "e1dad6e2d9d4e3d9d3e4d8d1e5d8d0e6d7cfe7d6cde7d6cce8d5cae9d4c9ead3c7ebd3c6"
    "ecd2c4ecd1c3edd0c1edcfc0eecfbeefcebcefcdbbf0ccb9f1cbb8f1cab6f2c9b5f2c8b3"
    "f2c7b2f3c6b0f3c5aff4c4adf4c3abf4c2aaf5c1a8f5c0a7f5bfa5f6bda4f6bca2f6bba0"
    "f6ba9ff6b99df6b79cf6b69af7b598f7b397f7b295f7b194f7b092f7ae91f7ad8ff6ab8d"
    "f6aa8cf6a98af6a789f6a687f6a486f6a384f5a182f5a081f59e7ff49d7ef49b7cf49a7b"
    "f39879f39678f39576f29375f29173f19072f18e70f08d6ff08b6def896cee876aee8669"
    "ed8467ec8266ec8064eb7f63ea7d61ea7b60e9795ee8775de7755ce6745ae67259e57057"
    "e46e56e36c54e26a53e16852e06650df644fde624edd604cdc5e4bdb5c4ada5a48d95847"
    "d85646d75444d65243d44f42d34d40d24b3fd1493ecf463dce443ccd423acc3f39ca3d38"
    "c93b37c83835c63534c53233c43032c22d31c12a30bf282ebe232dbc1f2cbb1a2bb9162a"
    "b81129b60d28b50827b30326")
TABLES = {name: np.frombuffer(bytes.fromhex(h), np.uint8).reshape(256, 3)
          for name, h in (("turbo", _TURBO), ("coolwarm", _COOLWARM))}


def lookup_u8(name: str, x: np.ndarray) -> np.ndarray:
    """float values in [0, 1] → uint8 RGB [..., 3]: entry ⌊x·256⌋ (x·256
    in x's own precision; 1.0 takes the last entry, values under 0 the
    first, over 1 the last) and black for NaN (matplotlib's "bad" colour,
    RGBA (0, 0, 0, 0))."""
    table = TABLES[name]
    xa = np.array(x, copy=True)
    xa *= 256
    xa[xa == 256] = 255
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, xa), -1, 256).astype(int)
    out = table[np.clip(idx, 0, 255)]
    out[bad] = 0
    return out
