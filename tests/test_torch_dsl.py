"""The port's config DSL (``paddle_tpu_torch/config/dsl.py``, with
``layer_math``, ``recurrent_units`` and ``v2/networks``) against the
JAX package's.

Each builder below makes the same DSL calls through either package's
modules; the two ``topology(...).to_json()`` texts must be equal — a
config is data, so also the layers the port cannot run yet (projections
and ``mixed``, generating groups, detection, 3-D, CRF, CTC) build the
same config.  ``LayerType.is_layer_type`` answers against each
package's layer registry and differs exactly on the unported types.
"""

import json

import pytest

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config import layer_math as jlm
from paddle_tpu.config import recurrent_units as jru
from paddle_tpu.config.model_config import ModelConfig as JModelConfig
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.v2 import networks as jnets
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config import layer_math as tlm
from paddle_tpu_torch.config import recurrent_units as tru
from paddle_tpu_torch.config.model_config import ModelConfig as TModelConfig
from paddle_tpu_torch.config.model_config import ProjConfig
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.v2 import networks as tnets

from test_dsl_parity import REFERENCE_ALL

JAX = dict(d=jdsl, f=jfeeder, n=jnets, ru=jru, lm=jlm)
PORT = dict(d=tdsl, f=tfeeder, n=tnets, ru=tru, lm=tlm)


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_public_names_equal_the_jax_dsl():
    assert _public(tdsl) == _public(jdsl)
    assert _public(tnets) == _public(jnets)
    assert set(tru.__all__) == set(jru.__all__)


def test_reference_all_names_exist():
    assert len(REFERENCE_ALL) == 111
    assert [n for n in REFERENCE_ALL if not hasattr(tdsl, n)] == []


# ----------------------------------------------------------------- builders
def b_fc(d, f, **_):
    x = d.data("x", f.dense_vector(16))
    h = d.fc(x, size=8, act=d.ReluActivation(),
             param_attr=d.ParamAttr(name="_w", initial_std=0.1, l2_rate=1e-3,
                                    learning_rate=0.5),
             bias_attr=d.ParamAttr(name="_b", initial_std=0.0))
    h = d.fc([h, x], size=4, act=d.TanhActivation(), bias_attr=False,
             layer_attr=d.ExtraAttr(drop_rate=0.5))
    return d.fc_layer(h, size=2, act=d.SoftmaxActivation(), name="out")


def b_embedding(d, f, **_):
    ids = d.data("ids", f.integer_value_sequence(100))
    e = d.embedding(ids, size=8, param_attr=d.ParamAttr(
        name="_emb", sparse_update=True, initial_std=0.02))
    e2 = d.embedding_layer(ids, size=8, vocab_size=100, sharded=True)
    return d.pooling(d.addto([e, e2], act=d.ReluActivation()),
                     pooling_type=d.SumPooling())


def b_lstm(d, f, n, **_):
    s = d.data("s", f.dense_vector_sequence(12))
    a = n.simple_lstm(s, size=8, name="a")
    b = d.lstmemory(d.fc(s, size=32, bias_attr=False), reverse=True,
                    act=d.TanhActivation(), gate_act=d.SigmoidActivation())
    c = n.bidirectional_lstm(s, size=4, name="bi", return_seq=True)
    return [d.last_seq(a), d.first_seq(b), d.last_seq(c)]


def b_gru(d, f, n, **_):
    s = d.data("s", f.dense_vector_sequence(12))
    a = n.simple_gru(s, size=8, name="g", reverse=True)
    b = d.grumemory(d.fc(s, size=24, bias_attr=False), name="g2")
    c = n.bidirectional_gru(s, size=4, name="bg")
    e = n.simple_gru2(s, size=4, name="g3")
    return [d.last_seq(a), d.last_seq(b), c, d.last_seq(e)]


def b_mixed_projections(d, f, **_):
    x = d.data("x", f.dense_vector(6))
    ids = d.data("ids", f.integer_value(20))
    s = d.data("s", f.dense_vector_sequence(6))
    m1 = d.mixed_layer(size=8, input=[
        d.full_matrix_projection(x, size=8),
        d.trans_full_matrix_projection(x, size=8),
        d.table_projection(ids, size=8)], act=d.TanhActivation(),
        bias_attr=True, name="m1")
    m2 = d.mixed_layer(input=[d.identity_projection(x),
                              d.dotmul_projection(x),
                              d.scaling_projection(x)], name="m2")
    m3 = d.mixed_layer(input=[d.identity_projection(x, offset=2, size=3)],
                       name="m3")
    m4 = d.mixed_layer(input=[d.slice_projection(x, [(0, 2), (4, 6)])],
                       name="m4")
    m5 = d.mixed_layer(input=[d.context_projection(
        s, context_len=3, context_start=-1,
        padding_attr=d.ParamAttr(name="_pad"))], name="m5")
    with d.mixed_layer(size=6, name="m6") as m6:
        m6 += d.full_matrix_projection(x, size=6)
        m6 += d.dotmul_operator(a=x, b=x, scale=0.5)
    return [m1, m2, m3, m4, d.last_seq(m5), m6]


def b_conv_projection_operator(d, f, **_):
    img = d.data("img", f.dense_vector(2 * 4 * 4), height=4, width=4)
    filt = d.data("filt", f.dense_vector(3 * 2 * 2 * 2))
    op = d.conv_operator(img, filt, filter_size=2, num_filters=3,
                         num_channels=2)
    proj = d.conv_projection(img, filter_size=3, num_filters=2,
                             num_channels=2, padding=1)
    return [d.mixed_layer(input=[op]), d.fc(proj, size=3)]


def b_recurrent_group(d, f, **_):
    s = d.data("s", f.dense_vector_sequence(6))
    boot = d.fc(d.last_seq(s), size=4, act=d.TanhActivation(), name="boot")
    static = d.fc(d.last_seq(s), size=3, name="static")

    def step(frame, st, b):
        mem = d.memory(name="h", size=4, boot_layer=b)
        mem2 = d.memory(name="acc", size=3)
        h = d.fc([frame, mem.out], size=4, act=d.TanhActivation(), name="h")
        acc = d.addto([mem2.out, st], name="acc")
        return [h, acc]

    out = d.recurrent_group(step, [d.StepInput(s), static, boot],
                            name="grp", reverse=True)
    return [d.last_seq(o) for o in out]


def b_lstm_step_group(d, f, n, **_):
    s = d.data("s", f.dense_vector_sequence(8))
    a = n.lstmemory_group(s, size=2, name="lg")
    b = n.gru_group(d.fc(s, size=6, bias_attr=False), size=2, name="gg")
    return [d.last_seq(a), d.last_seq(b)]


def b_recurrent_units(d, f, ru, **_):
    s = d.data("s", f.dense_vector_sequence(8))
    a = ru.LstmRecurrentLayerGroup(
        "lru", 3, "tanh", "tanh", "sigmoid",
        [d.full_matrix_projection(s, size=12)])
    b = ru.GatedRecurrentLayerGroup(
        "gru", 3, "tanh", "sigmoid",
        [d.full_matrix_projection(s, size=9)], seq_reversed=True)
    return [d.last_seq(a), d.last_seq(b)]


def _adjust(logp, tokens, t):
    return logp


def b_beam_search(d, f, **_):
    src = d.data("src", f.dense_vector(4))
    enc = d.fc(src, size=8, act=d.TanhActivation(), name="enc")

    def step(enc_s, prev_emb):
        mem = d.memory(name="dec_state", size=8, boot_layer=enc_s)
        h = d.fc([prev_emb, mem.out], size=8, act=d.TanhActivation(),
                 name="dec_state")
        return d.fc(h, size=11, act=d.SoftmaxActivation(), name="dec_prob")

    return d.beam_search(
        step, input=[d.StaticInput(enc),
                     d.GeneratedInput(size=11, embedding_name="_trg_emb",
                                      embedding_size=5)],
        bos_id=0, eos_id=1, beam_size=3, max_length=6,
        candidate_adjust=_adjust)


def b_image(d, f, **_):
    img = d.data("img", f.dense_vector(3 * 16 * 16), height=16, width=16)
    c = d.img_conv(img, filter_size=3, num_filters=8, num_channels=3,
                   padding=1, stride=1, act=d.ReluActivation())
    p = d.img_pool(c, pool_size=3, stride=2, padding=1,
                   pool_type=d.MaxPooling())
    bn = d.batch_norm(p, act=d.ReluActivation(), use_global_stats=False)
    n = d.img_cmrnorm_layer(bn, size=5, scale=0.0001, power=0.75)
    ap = d.img_pool(n, pool_size=2, stride=2, pool_type=d.AvgPooling())
    mo = d.maxout_layer(ap, groups=2)
    sp = d.spp_layer(c, pyramid_height=2)
    bi = d.bilinear_interp(c, out_size_x=8, out_size_y=8)
    tc = d.img_conv(c, filter_size=2, num_filters=4, stride=2, trans=True)
    return [d.fc(mo, size=4), d.fc(sp, size=4), d.fc(bi, size=4),
            d.fc(tc, size=4)]


def b_networks_image(d, f, n, **_):
    img = d.data("img", f.dense_vector(3 * 16 * 16), height=16, width=16)
    g = n.img_conv_group(img, conv_num_filter=[4, 4], pool_size=2,
                         num_channels=3, conv_padding=1, conv_filter_size=3,
                         conv_act=d.ReluActivation(), conv_with_batchnorm=True,
                         pool_stride=2)
    p = n.simple_img_conv_pool(img, filter_size=3, num_filters=4,
                               num_channel=3, pool_size=2, pool_stride=2)
    b = n.img_conv_bn_pool(img, filter_size=3, num_filters=4,
                           num_channel=3, pool_size=2, pool_stride=2)
    return [d.fc(g, size=3), d.fc(p, size=3), d.fc(b, size=3)]


def b_networks_text(d, f, n, **_):
    s = d.data("s", f.integer_value_sequence(50))
    e = d.embedding(s, size=8)
    cp = n.sequence_conv_pool(e, context_len=3, hidden_size=6)
    st = n.stacked_lstm_net(e, hid_dim=4, stacked_num=3)
    enc = d.fc(e, size=6, name="enc")
    encp = d.fc(enc, size=6, name="encp", bias_attr=False)
    state = d.fc(d.last_seq(enc), size=6, name="state")
    att = n.simple_attention(enc, encp, state, name="att")
    dot = n.dot_product_attention(enc, enc, state, name="dot")
    return [cp, d.fc(att, size=2), d.fc(dot, size=2)] + \
        ([st] if not isinstance(st, (list, tuple)) else list(st))


def b_priorbox_detection(d, f, **_):
    img = d.data_layer("image", f.dense_vector(3 * 16 * 16), height=16,
                       width=16)
    feat = d.img_conv_layer(img, filter_size=3, num_filters=8,
                            num_channels=3, padding=1, stride=2)
    normed = d.cross_channel_norm_layer(feat)
    pb = d.priorbox_layer(normed, img, aspect_ratio=[2.0],
                          variance=[0.1, 0.1, 0.2, 0.2], min_size=[4.0],
                          max_size=[8.0])
    n_priors = pb.size // 8
    loc = d.img_conv_layer(normed, filter_size=3,
                           num_filters=4 * (n_priors // 64), padding=1,
                           name="loc")
    conf = d.img_conv_layer(normed, filter_size=3,
                            num_filters=3 * (n_priors // 64), padding=1,
                            name="conf")
    lab = d.data_layer("gt", f.dense_vector_sequence(6))
    loss = d.multibox_loss_layer(input_loc=loc, input_conf=conf,
                                 priorbox=pb, label=lab, num_classes=3)
    det = d.detection_output_layer(input_loc=loc, input_conf=conf,
                                   priorbox=pb, num_classes=3, keep_top_k=8)
    return [loss, det]


def b_conv3d(d, f, **_):
    vol = d.data("vol", f.dense_vector(2 * 6 * 6 * 6))
    c = d.img_conv3d_layer(vol, filter_size=3, num_filters=4,
                           num_channels=2, padding=1)
    p = d.img_pool3d_layer(c, pool_size=2, stride=2)
    dc = d.img_conv3d_layer(p, filter_size=2, num_filters=2, stride=2,
                            trans=True)
    return d.fc(dc, size=3)


def b_costs(d, f, **_):
    x = d.data("x", f.dense_vector(8))
    lab = d.data("lab", f.integer_value(4))
    y = d.data("y", f.dense_vector(4))
    w = d.data("w", f.dense_vector(1))
    p = d.fc(x, size=4, act=d.SoftmaxActivation(), name="p")
    r = d.fc(x, size=4, name="r")
    s1 = d.fc(x, size=1, name="s1")
    s2 = d.fc(x, size=1, name="s2")
    return [
        d.classification_cost(p, lab, weight=w),
        d.cross_entropy(p, lab, coeff=0.5),
        d.cross_entropy_with_selfnorm(p, lab, softmax_selfnorm_alpha=0.2),
        d.square_error_cost(r, y), d.regression_cost(r, y),
        d.multi_binary_label_cross_entropy(p, y),
        d.soft_binary_class_cross_entropy_cost(p, y),
        d.rank_cost(s1, s2, d.data("rl", f.dense_vector(1))),
        d.huber_regression_cost(r, y, delta=0.5),
        d.huber_classification_cost(s1, d.data("hl", f.integer_value(2))),
        d.smooth_l1_cost(r, y), d.sum_cost(s1),
        d.nce_layer(x, lab, num_classes=4, num_neg_samples=2),
        d.hsigmoid(x, lab, num_classes=4)]


def b_sequence_costs(d, f, **_):
    s = d.data("s", f.dense_vector_sequence(6))
    tags = d.data("tags", f.integer_value_sequence(5))
    emit = d.fc(s, size=5, name="emit")
    score = d.fc(s, size=1, name="score")
    return [d.crf_layer(emit, tags, size=5),
            d.crf_decoding_layer(emit, size=5),
            d.ctc_layer(d.fc(s, size=6, name="ctc_in"), tags, size=6),
            d.warp_ctc_layer(d.fc(s, size=6, name="wctc_in"), tags, size=6),
            d.lambda_cost(score, d.data("rel", f.dense_vector_sequence(1)),
                          NDCG_num=3)]


def b_evaluators(d, f, **_):
    x = d.data("x", f.dense_vector(8))
    lab = d.data("lab", f.integer_value(2))
    p = d.fc(x, size=2, act=d.SoftmaxActivation(), name="p")
    d.classification_error_evaluator(p, lab)
    d.auc_evaluator(p, lab, name="auc")
    d.precision_recall_evaluator(p, lab, positive_label=1)
    d.sum_evaluator(p)
    d.column_sum_evaluator(p, name="cols")
    d.pnpair_evaluator(p, lab, d.data("q", f.integer_value(5)))
    d.value_printer_evaluator(p)
    return d.classification_cost(p, lab)


def b_sequence_layers(d, f, **_):
    a = d.data("a", f.dense_vector_sequence(6))
    b = d.data("b", f.dense_vector_sequence(6))
    v = d.data("v", f.dense_vector(6))
    off = d.data("off", f.integer_value(4))
    cat = d.seq_concat_layer(a, b)
    ex = d.expand_layer(d.fc(v, size=6), expand_as=a)
    rs = d.seq_reshape_layer(a, reshape_size=3)
    sl = d.seq_slice_layer(a, starts=off, ends=None)
    sub = d.sub_seq(a, offsets=off, sizes=off)
    sc = d.fc(a, size=1, name="sc")
    km = d.kmax_seq_score_layer(sc, beam_size=2)
    mx = d.maxid_layer(d.fc(a, size=5, act=d.SoftmaxActivation()))
    smp = d.sampling_id_layer(d.fc(v, size=5, act=d.SoftmaxActivation()))
    eos = d.eos_layer(mx, eos_id=1)
    pools = [d.pooling_layer(cat, pooling_type=t()) for t in
             (d.MaxPooling, d.AvgPooling, d.SumPooling, d.SqrtPooling)]
    rc = d.row_conv_layer(a, context_len=2)
    return pools + [d.last_seq(ex), d.last_seq(rs), d.last_seq(sl),
                    d.last_seq(sub), km, eos, smp, d.last_seq(rc)]


def b_dense_misc(d, f, **_):
    a = d.data("a", f.dense_vector(6))
    b = d.data("b", f.dense_vector(6))
    k = d.data("k", f.dense_vector(5))
    one = d.data("one", f.dense_vector(1))
    idx = d.data("idx", f.integer_value(2))
    return [
        d.slope_intercept_layer(a, slope=2.0, intercept=1.0),
        d.clip_layer(a, min=-1.0, max=1.0), d.scale_shift_layer(a),
        d.cos_sim(a, b, scale=2.0), d.prelu_layer(a, partial_sum=2),
        d.multiplex_layer(idx, [a, b]), d.power_layer([one, a]),
        d.scaling_layer([one, a]), d.interpolation_layer([one, a, b]),
        d.dot_prod_layer([a, b]),
        d.trans_layer(a), d.sum_to_one_norm_layer(a),
        d.row_l2_norm_layer(a), d.out_prod_layer([a, b]),
        d.tensor_layer(a, b, size=4), d.conv_shift_layer(a, k),
        d.linear_comb_layer(weights=d.fc(a, size=3, bias_attr=False),
                            vectors=d.fc(b, size=12, bias_attr=False),
                            size=4),
        d.convex_comb_layer([d.fc(a, size=2, bias_attr=False),
                             d.fc(b, size=8, bias_attr=False)]),
        d.gated_unit_layer(a, size=4), d.selective_fc_layer(a, size=7),
        d.repeat_layer(a, 2), d.resize_layer(a, 3),
        d.dropout_layer(a, dropout_rate=0.3), d.print_layer(a),
        d.layer_norm(a, name="ln"), d.concat_layer([a, b])]


def b_image_glue(d, f, **_):
    img = d.data_layer("img", f.dense_vector(3 * 8 * 8), height=8, width=8)
    conv = d.img_conv_layer(img, filter_size=3, num_filters=4,
                            num_channels=3, padding=1)
    padded = d.pad_layer(conv, pad_c=[1, 1], pad_h=[0, 0], pad_w=[0, 0])
    cropped = d.crop_layer(conv, offset=[1, 1], shape=[4, 4])
    rot = d.rotate_layer(d.resize_layer(cropped, 4 * 4 * 4), 4, 4)
    sw = d.switch_order_layer(conv, reshape_axis=3)
    blk = d.block_expand_layer(conv, block_x=2, block_y=2, stride_x=2,
                               stride_y=2, num_channels=4)
    return d.concat_layer([d.fc_layer(padded, size=3),
                           d.fc_layer(rot, size=3), d.fc_layer(sw, size=3),
                           d.fc_layer(d.pooling_layer(blk), size=3)])


def b_steps_and_outputs(d, f, **_):
    s = d.data("s", f.dense_vector_sequence(6))

    def step(frame):
        m = d.memory(name="lstm_out", size=2)
        c = d.memory(name="lstm_out.state", size=2)
        gates = d.fc_layer(input=[frame, m.out], size=8,
                           act=d.LinearActivation(), bias_attr=False,
                           name="gates")
        out = d.lstm_step_layer(gates, c.out, size=2, name="lstm_out",
                                bias_attr=False)
        g = d.memory(name="gru_out", size=2)
        gin = d.fc(frame, size=6, bias_attr=False, name="gin")
        gru = d.gru_step_naive_layer(gin, g.out, size=2, name="gru_out")
        return [out, d.get_output_layer(out, "state", name="cell"), gru]

    outs = d.recurrent_group(step, [d.StepInput(s)], name="g")
    rec = d.recurrent_layer(d.fc(s, size=4, name="rin"), reverse=True)
    return [d.last_seq(o) for o in outs] + [d.last_seq(rec)]


def b_attention(d, f, **_):
    s = d.data("s", f.integer_value_sequence(40))
    e = d.position_embedding(d.embedding(s, size=16), max_len=64)
    a = d.scaled_dot_product_attention(d.layer_norm(e, name="ln"), size=16,
                                       num_heads=2, causal=True, packed=True,
                                       block_q=16, block_k=16, name="att",
                                       bias_attr=True)
    return d.pooling_layer(d.addto([e, a]), pooling_type=d.AvgPooling())


def b_layer_math(d, f, lm, **_):
    a = d.data("a", f.dense_vector(4))
    b = d.data("b", f.dense_vector(4))
    one = d.data("one", f.dense_vector(1))
    # (a * one, a size-1 operand, raises IndexError in both packages:
    # layer_math.mul calls scaling_layer(input=, weight=); ROADMAP queue
    # C)
    return [a + b, a - b, 2.0 * a, a * 0.5, 1.0 - a, a + one, one + a,
            a + 3.0, lm.exp(a), lm.log(b), lm.tanh(a), lm.sigmoid(a),
            lm.relu(a), lm.sqrt(b), lm.square(a), lm.abs(a),
            lm.reciprocal(b)]


def b_beam_cost(d, f, **_):
    s = d.data("s", f.dense_vector_sequence(4))
    sc = d.fc(s, size=1, name="sc")
    sel = d.kmax_seq_score_layer(sc, beam_size=2)
    gold = d.data("gold", f.integer_value(4))
    nested = d.data("nested", f.dense_vector_sub_sequence(3))
    picked = d.sub_nested_seq_layer(nested, d.data("pick",
                                                   f.integer_value(4)))
    return [d.cross_entropy_over_beam([d.BeamInput(sc, sel, gold)]),
            d.last_seq(picked)]


BUILDERS = {k[2:]: v for k, v in dict(globals()).items()
            if k.startswith("b_")}


def _config(pkg, builder) -> str:
    d = pkg["d"]
    with d.config_scope():
        return d.topology(builder(**pkg)).to_json()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_json_equals_the_jax_dsl(name):
    j = _config(JAX, BUILDERS[name])
    t = _config(PORT, BUILDERS[name])
    assert t == j
    assert len(json.loads(t)["layers"]) > 1


@pytest.mark.parametrize("name", ["mixed_projections", "beam_search",
                                  "recurrent_units", "conv3d"])
def test_from_json_reads_jax_configs(name):
    """JAX JSON with projections, sub-models, generators and 3-D
    geometry round-trips through the port's ``from_json``."""
    text = _config(JAX, BUILDERS[name])
    back = TModelConfig.from_json(text)
    assert back.to_json() == text
    assert JModelConfig.from_json(text).to_json() == text
    if name == "mixed_projections":
        projs = [i.proj for l in back.layers for i in l.inputs if i.proj]
        assert projs and all(isinstance(p, ProjConfig) for p in projs)
        assert {p.type for p in projs} >= {"fc", "trans_fc", "table",
                                           "identity", "dot_mul",
                                           "scaling", "slice", "context"}


def test_is_layer_type_differs_exactly_on_the_unported_types():
    from paddle_tpu.layers import LAYERS as J
    from paddle_tpu_torch.layers import network  # noqa: F401
    from paddle_tpu_torch.layers.base import LAYERS as T
    jtypes = set(J._entries) | set(J._aliases)
    assert set(T) <= jtypes
    differ = {t for t in jtypes if jdsl.LayerType.is_layer_type(t)
              != tdsl.LayerType.is_layer_type(t)}
    assert differ == jtypes - set(T)
    assert all(jdsl.LayerType.is_layer_type(t) for t in jtypes)
    # 110 types in the reference's registry, 88 ported (queue A14's
    # image, 3-D and detection types are the rest)
    assert (len(jtypes), len(T), len(differ)) == (110, 88, 22)
    assert tdsl.LayerType.is_layer_type("mixed")
    assert tdsl.LayerType.is_layer_type("tensor")
    assert tdsl.LayerType.is_layer_type("crf")
    assert not tdsl.LayerType.is_layer_type("norm")
    assert tdsl.LayerType.is_layer_type(tdsl.LayerType.LSTMEMORY)


def test_config_errors_are_the_ports():
    from paddle_tpu_torch.utils import ConfigError
    with tdsl.config_scope():
        a = tdsl.data_layer("a", tfeeder.dense_vector(6))
        with pytest.raises(ConfigError):
            tdsl.concat_layer([a, tdsl.full_matrix_projection(a, size=4)])
        with pytest.raises(ConfigError, match="duplicate"):
            tdsl.data_layer("a", tfeeder.dense_vector(6))
