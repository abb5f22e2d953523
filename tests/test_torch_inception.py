"""The port's InceptionV3 and its ingestion against the JAX package's, on the CPU.

The network runs at 75x75, the smallest input the architecture takes, so that no flax
``init`` or apply runs at 299: the port draws the weights (its He-scaled random init,
with every BatchNorm's scale, bias and running statistics drawn off their defaults) and
hands them to flax through ``weights.inception_flax_paths``, whose paths are held
against ``jax.eval_shape`` of the flax ``init``. Features and logits agree within 1e-4
of 1 + |ref| in f32. The ingestion (uint8 -> /255 -> 1 channel repeated to 3 ->
bilinear 299x299 -> x 2 - 1) is held against ``jax.image.resize`` at 28 and 32 px, 1
and 3 channels.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.metrics import inception as JI
from lightning_generative_models_tpu_torch.metrics import inception as TI
from lightning_generative_models_tpu_torch.weights import (
    flatten_tree,
    inception_flax_paths,
    load_flax_inception,
)
from torch_flax_params import _INVERSE
from torch_inception_ref import TorchInceptionV3

torch.set_num_threads(1)

SIZE = 75
TOL = 1e-4


def _port_net(seed=0):
    """He-scaled random weights, BatchNorms drawn off scale 1, bias 0, mean 0, var 1."""
    net = TI.he_scaled_random_init(TI.InceptionV3(), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.copy_(0.5 + torch.rand(c, generator=gen))
                mod.bias.copy_(0.2 * torch.randn(c, generator=gen))
                mod.running_mean.copy_(0.2 * torch.randn(c, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return net.eval()


def _flax_variables(net):
    tree = {}
    for path, (tensor, transform) in inception_flax_paths(net).items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.array(_INVERSE[transform](tensor.detach().numpy()), order="C")
    return tree


def _close(got, ref, tol=TOL):
    err = np.max(np.abs(np.asarray(got, np.float64) - ref) / (1.0 + np.abs(ref)))
    assert err <= tol, err
    return err


def test_inception_v3_matches_flax():
    """Features and logits of the port's net against the flax module with the same
    variables; the variable paths are flax's own, and an unmatched leaf raises."""
    net = _port_net()
    variables = _flax_variables(net)
    shapes = jax.eval_shape(JI.InceptionV3().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: v.shape for k, v in flatten_tree(variables).items()} == want

    x = np.random.RandomState(0).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    feats, logits = jax.jit(JI.InceptionV3().apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        tf, tl = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert tf.shape == (2, TI.FEATURE_DIM) and tl.shape == (2, TI.NUM_LOGITS)
    assert np.std(np.asarray(feats), axis=0).mean() > 1e-3  # input-dependent features
    _close(tf.numpy(), np.asarray(feats))
    _close(tl.numpy(), np.asarray(logits))

    # The flax variables back into a fresh port net give the same outputs.
    net2 = load_flax_inception(TI.InceptionV3().eval(), variables)
    with torch.no_grad():
        assert torch.equal(net2(torch.from_numpy(x.transpose(0, 3, 1, 2)))[1], tl)
    flat = flatten_tree(variables)
    with pytest.raises(KeyError, match="missing"):
        load_flax_inception(TI.InceptionV3(), {k: v for k, v in flat.items()
                                               if "InceptionC_2/BasicConv_4" not in k})
    with pytest.raises(KeyError, match="left over"):
        load_flax_inception(TI.InceptionV3(), {**flat, "params/Dense_1/bias": flat[
            "params/Dense_0/bias"]})


@pytest.mark.parametrize("size,channels", [(28, 1), (32, 3)])
def test_ingestion_matches_jax_resize(size, channels):
    """uint8 -> the network's 299x299 input in [-1, 1]: ``F.interpolate`` (bilinear,
    ``align_corners=False``, no antialiasing) against ``jax.image.resize(bilinear)``,
    edge rows included, to f32 rounding."""
    images = np.random.RandomState(size).randint(0, 256, (3, size, size, channels),
                                                 dtype=np.uint8)
    x = jnp.asarray(images, jnp.float32) / 255.0
    if channels == 1:
        x = jnp.repeat(x, 3, axis=-1)
    ref = np.asarray(jax.image.resize(x, (3, 299, 299, 3), method="bilinear") * 2.0 - 1.0)
    got = TI.ingest(images, torch.device("cpu")).numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= 1e-6, err
    assert np.abs(got[:, [0, -1]] - ref[:, [0, -1]]).max() <= 1e-6


def test_load_torch_weights_gives_the_reference_nets_outputs(tmp_path):
    """A torchvision-layout ``state_dict`` (the test reference net, aux head included
    as torchvision's and pytorch-fid's files hold it) loads directly: the port's net
    then gives the reference net's features and logits. A file without ``fc`` keeps the
    head; a missing conv or a wrong shape raises."""
    torch.manual_seed(0)
    ref = TorchInceptionV3().eval()
    for mod in ref.modules():
        if isinstance(mod, torch.nn.Conv2d):
            torch.nn.init.kaiming_normal_(mod.weight, mode="fan_in", nonlinearity="relu")
        if isinstance(mod, torch.nn.BatchNorm2d):
            torch.nn.init.uniform_(mod.running_var, 0.5, 1.5)
            torch.nn.init.normal_(mod.running_mean, 0.0, 0.2)
    sd = {**ref.state_dict(), "AuxLogits.fc.weight": torch.zeros(1000, 768)}
    path = tmp_path / "inception.pt"
    torch.save(sd, path)
    net = TI.load_torch_weights(path)
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 3, SIZE, SIZE))
                         .astype(np.float32))
    with torch.no_grad():
        rf, rl = ref(x)
        pf, pl = net.eval()(x)
    assert torch.equal(pf, rf) and torch.equal(pl, rl)

    no_fc = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    torch.save(no_fc, path)
    head = TI.InceptionV3().fc.weight.detach().clone()
    kept = TI.InceptionV3()
    kept.fc.weight.data.copy_(head)
    assert torch.equal(TI.load_torch_weights(path, kept).fc.weight, head)
    torch.save({k: v for k, v in sd.items() if "Mixed_6c.branch7x7_2" not in k}, path)
    with pytest.raises(KeyError, match="Mixed_6c.branch7x7_2"):
        TI.load_torch_weights(path)
    torch.save({**sd, "fc.bias": torch.zeros(1000)}, path)
    with pytest.raises(ValueError, match="fc.bias"):
        TI.load_torch_weights(path)


def test_pretrained_weights_search_and_sha256_pin(tmp_path, monkeypatch):
    """The JAX package's search and pin: ``LGM_TPU_INCEPTION_WEIGHTS`` first, a pin of
    fewer than 8 hex characters or a digest that does not match raises, a matching pin
    passes, and an extractor built from the file says it is pretrained."""
    path = tmp_path / "pt_inception.pth"
    torch.save(TI.InceptionV3().state_dict(), path)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    monkeypatch.setenv("LGM_TPU_INCEPTION_WEIGHTS", str(path))
    assert TI.weight_search_paths()[0] == path
    assert TI.weight_search_paths()[1:] == [p for p in JI.weight_search_paths()[1:]]
    monkeypatch.setenv("LGM_TPU_INCEPTION_SHA256", digest[:4])
    with pytest.raises(ValueError, match="at least 8"):
        TI.find_pretrained_weights()
    monkeypatch.setenv("LGM_TPU_INCEPTION_SHA256", "0" * 8 if digest[0] != "0" else "1" * 8)
    with pytest.raises(ValueError, match="does not match"):
        TI.find_pretrained_weights()
    monkeypatch.setenv("LGM_TPU_INCEPTION_SHA256", digest[:12])
    assert TI.find_pretrained_weights() == path
    assert TI.InceptionFeatureExtractor(device="cpu").pretrained
    monkeypatch.setenv("LGM_TPU_INCEPTION_WEIGHTS", str(tmp_path / "absent.pth"))
    monkeypatch.delenv("LGM_TPU_INCEPTION_SHA256")
    monkeypatch.setattr(TI, "weight_search_paths", lambda: [tmp_path / "absent.pth"])
    assert TI.find_pretrained_weights() is None
    assert not TI.InceptionFeatureExtractor(device="cpu").pretrained
