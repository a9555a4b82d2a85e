"""repro_torch models vs ``jax.vmap(repro.models.model.score)`` on weights
carried across with ``repro_torch.params``.

Tolerances: mlp atol 1e-5 (fp32 matmuls summed in another order);
resnet-tiny atol 1e-4 (convolutions and GroupNorm statistics summed in
another order through eight layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import mlp_config as jax_mlp_config
from repro.models import model as JM
from repro.models import resnet as JR
from repro_torch import params as P
from repro_torch.configs import get_smoke_config, mlp_config
from repro_torch.models import model as M
from repro_torch.models import resnet as R
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)


def _stacked_jax_params(jcfg, K, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    tree = jax.vmap(lambda k: JM.init_params(k, jcfg))(keys)
    return jax.tree_util.tree_map(np.asarray, tree)


def _score_both(jcfg, tcfg, tree, inputs):
    want, _ = jax.vmap(lambda p, x: JM.score(jcfg, p, x))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in inputs.items()})
    got, aux = M.score(tcfg, P.from_jax_params(tcfg, tree),
                       {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert got.shape == want.shape and got.dtype == torch.float32
    assert aux.shape == (want.shape[0],) and not aux.any()
    return got.detach().numpy(), np.asarray(want)


def test_mlp_score_matches_reference():
    K, B = 3, 16
    tree = _stacked_jax_params(jax_mlp_config(), K, 0)
    # non-zero biases so the bias broadcast over the batch is exercised
    rng = np.random.default_rng(0)
    for layer in tree["mlp"]:
        layer["b"] = rng.normal(0, 0.1, layer["b"].shape).astype(np.float32)
    tree["score_head"]["b"] = np.full((K, 1), 0.2, np.float32)
    x = rng.standard_normal((K, B, 64)).astype(np.float32)
    got, want = _score_both(jax_mlp_config(), mlp_config(), tree, {"features": x})
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw", [8, 16])
def test_resnet_tiny_score_matches_reference(hw):
    K, B = 2, 3
    tree = _stacked_jax_params(jax_smoke_config("resnet50"), K, 1)
    rng = np.random.default_rng(hw)
    x = rng.standard_normal((K, B, hw * hw, 3)).astype(np.float32)
    got, want = _score_both(jax_smoke_config("resnet50"),
                            get_smoke_config("resnet50"), tree, {"images": x})
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("n", [7, 8, 16, 32])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_conv_same_padding_matches_xla(n, k, s):
    """XLA's "SAME" is asymmetric for stride 2 on even inputs (0 before, 1
    after for a 3×3 on 32 px); the port pads explicitly to match it."""
    K, B, cin, cout = 2, 2, 3, 4
    rng = np.random.default_rng(n * 10 + k + s)
    x = rng.standard_normal((B, n, n, K * cin)).astype(np.float32)
    w = rng.standard_normal((K, k, k, cin, cout)).astype(np.float32)
    want = np.concatenate([
        np.asarray(JR._conv(jnp.asarray(x[..., i * cin:(i + 1) * cin]),
                            jnp.asarray(w[i]), s)) for i in range(K)], axis=-1)
    got = R._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(w).permute(0, 4, 3, 1, 2), s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)
    if (n, k, s) == (32, 3, 2):
        assert R._same_pad(n, k, s) == (0, 1)


def test_stride2_block_with_identity_shortcut():
    """A stride-2 block whose cin == cout takes the reference's 1×1 identity
    convolution at stride 2 (``x[:, :, ::2, ::2]`` in the port), after the
    asymmetric SAME padding of its 3×3."""
    jcfg = jax_smoke_config("resnet50")
    K = 2
    keys = jax.random.split(jax.random.PRNGKey(3), K)

    def init(key):
        p = JR.init_resnet(key, jcfg)
        ks = jax.random.split(key, 3)
        c = p["stages"][0][0]["w3"].shape[-1]            # stage-1 width (64)
        mid = c // 4
        p["stages"][1] = [{
            "w1": JR._conv_init(ks[0], 1, 1, c, mid, jnp.float32), "gn1": JR._gn_init(mid),
            "w2": JR._conv_init(ks[1], 3, 3, mid, mid, jnp.float32), "gn2": JR._gn_init(mid),
            "w3": JR._conv_init(ks[2], 1, 1, mid, c, jnp.float32), "gn3": JR._gn_init(c)}]
        return p

    tree = jax.tree_util.tree_map(np.asarray, jax.vmap(init)(keys))
    x = np.random.default_rng(5).standard_normal((K, 2, 16, 16, 3)).astype(np.float32)
    want = jax.vmap(lambda p, im: JR.apply_resnet(jcfg, p, im))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    port = P.from_jax_params(get_smoke_config("resnet50"), {"backbone": tree})
    got = R.apply_resnet(get_smoke_config("resnet50"), port["backbone"],
                         torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_params_round_trip_and_layout():
    tcfg = get_smoke_config("resnet50")
    tree = _stacked_jax_params(jax_smoke_config("resnet50"), 2, 4)
    port = P.from_jax_params(tcfg, tree)
    w = tree["backbone"]["stages"][1][0]["w2"]                # [K, kh, kw, I, O]
    assert tuple(port["backbone"]["stages"][1][0]["w2"].shape) == (
        w.shape[0], w.shape[4], w.shape[3], w.shape[1], w.shape[2])
    back = P.to_jax_params(tcfg, port)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = {"w": np.asarray(jnp.asarray([[1.5, -2.25]], jnp.bfloat16))}
    t = P.from_jax_params(mlp_config(), bf)["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(P.to_jax_params(mlp_config(), {"w": t})["w"],
                                  np.asarray(bf["w"], np.float32))


def test_resnet50_has_the_references_parameter_count():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_leaves
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jax_get_config("resnet50")),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    jl = jax.tree_util.tree_leaves(shapes)
    tl = tree_leaves(M.init_params(get_config("resnet50")))
    assert len(tl) == len(jl) == 153
    assert [t.numel() for t in tl] == [int(np.prod(x.shape)) for x in jl]
    assert sum(t.numel() for t in tl) == 23_494_721


def test_unported_family_raises():
    """A family or arch name that does not exist is refused (every family
    of the reference is ported)."""
    import dataclasses
    with pytest.raises(ValueError, match="unknown family"):
        M.init_params(dataclasses.replace(mlp_config(), family="quantum"))
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("quantum-1b")
