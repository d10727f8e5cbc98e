"""The port's TF1 checkpoint reader and converter (convert/tf_ckpt.py)
against disn_tpu's and TensorFlow's own reader, on bundles written by
TensorFlow (skipped where TensorFlow is not installed). Every tensor and
every param leaf compares exactly."""
import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from disn_tpu.convert import tf_ckpt as jtf_ckpt  # noqa: E402
from disn_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from disn_tpu_torch import convert  # noqa: E402
from disn_tpu_torch.convert import tf_ckpt  # noqa: E402
from disn_tpu_torch.train import checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A bundle with slim-style names of every scope the converter maps,
    optimizer slots and counters, and tensors of several types."""
    import tensorflow.compat.v1 as tf1
    d = tmp_path_factory.mktemp("tfckpt")
    prefix = str(d / "model.ckpt")
    rng = np.random.RandomState(0)
    tensors = {
        "vgg_16/conv1/conv1_1/weights":
            rng.randn(3, 3, 3, 8).astype(np.float32),
        "vgg_16/conv1/conv1_1/biases": rng.randn(8).astype(np.float32),
        "vgg_16/fc8/weights": rng.randn(1, 1, 16, 4).astype(np.float32),
        "alexnet/conv2/weights": rng.randn(5, 5, 8, 16).astype(np.float32),
        "resnet_v1/stage1/block1/conv_a/weights":
            rng.randn(3, 3, 8, 8).astype(np.float64),
        "sdfprediction/fold1/conv1/weights":
            rng.randn(1, 1, 3, 64).astype(np.float32),
        "sdfprediction/fold1/conv1/biases": rng.randn(64).astype(np.float16),
        "sdfprediction_imgfeat/fold2/conv5/weights":
            rng.randn(1, 1, 256, 1).astype(np.float32),
        "sdfimgfeat/fold2/conv1/weights":
            rng.randn(1, 1, 960, 512).astype(np.float32),
        "cameraprediction/translation/fc3/weights":
            rng.randn(64, 3).astype(np.float32),
        "sdf3dcnn/deconv1/weights": rng.randn(2, 2, 2, 4, 8).astype(
            np.float32),
        "counts/int32": rng.randint(-9, 9, (5,)).astype(np.int32),
        "counts/uint8": rng.randint(0, 255, (3, 2)).astype(np.uint8),
        "vgg_16/conv1/conv1_1/weights/Adam":
            rng.randn(3, 3, 3, 8).astype(np.float32),
        "beta1_power": np.float32(0.5),
        "global_step": np.int64(1234),
    }
    g = tf1.Graph()
    with g.as_default():
        tvars = {k: tf1.get_variable(k, initializer=v)
                 for k, v in tensors.items()}
        tvars["label"] = tf1.get_variable(
            "label", initializer=tf1.constant("text"))
        saver = tf1.train.Saver(var_list=tvars)
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, prefix, write_meta_graph=False,
                       write_state=False)
    return prefix, tensors


def test_reader_matches_jax_and_tf(bundle):
    """read_tf_checkpoint: every tensor of TensorFlow's reader but the
    string one, bit for bit, and the same dict as disn_tpu's reader."""
    prefix, tensors = bundle
    got = tf_ckpt.read_tf_checkpoint(prefix)
    want = jtf_ckpt.read_tf_checkpoint(prefix)
    reader = tf.train.load_checkpoint(prefix)
    assert set(got) == set(want) == set(tensors)
    assert "label" in reader.get_variable_to_shape_map()
    for name in want:
        assert got[name].dtype == want[name].dtype == tensors[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(got[name], reader.get_tensor(name))


def test_param_tree_matches_jax(bundle):
    """tf_vars_to_params: the same tree (1x1 kernels of the point-MLP
    scopes squeezed, the encoders' and 3D-CNN's kept, optimizer slots and
    counters dropped)."""
    prefix, _ = bundle
    tf_vars = tf_ckpt.read_tf_checkpoint(prefix)
    got = dict(checkpoint.leaves(tf_ckpt.tf_vars_to_params(tf_vars)))
    want = dict(checkpoint.leaves(jtf_ckpt.tf_vars_to_params(tf_vars)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert got["sdfimgfeat$fold2$conv1$weights"].shape == (960, 512)
    assert got["vgg_16$fc8$weights"].shape == (1, 1, 16, 4)
    assert not any("Adam" in k or "global_step" in k or "beta1" in k
                   for k in got)


def test_convert_checkpoint_restores_in_both_packages(bundle, tmp_path):
    """convert_checkpoint's npz: disn_tpu's restore_params and the port's
    load_npz read back the tree it returned; its metadata names the
    source, as disn_tpu's does."""
    prefix, _ = bundle
    out = str(tmp_path / "params.npz")
    params = convert.convert_checkpoint(prefix, out)
    jout = str(tmp_path / "jparams.npz")
    jtf_ckpt.convert_checkpoint(prefix, jout)
    want = dict(checkpoint.leaves(params))
    for tree in (jcheckpoint.restore_params(out)["params"],
                 convert.load_npz(out)["params"]):
        got = dict(checkpoint.leaves(tree))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert checkpoint.load_metadata(out) == jcheckpoint.load_metadata(jout)
