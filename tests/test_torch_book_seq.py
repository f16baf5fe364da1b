"""The three sequence book chapters and the stacked LSTM model, the port
against the JAX package on the CPU.

understand_sentiment (its convolution net, two sequence_conv_pool, and
its stacked LSTM net), recommender and label_semantic_roles are built as
tests/test_book_*.py build them, and models.stacked_lstm at small
widths. Each is built in both packages under the same names, the JAX
package's initial persistables are copied into the port
(io.load_numpy_params), both are fed the same batches through
fluid.batch + DataFeeder (the LoD branch: each batch padded to its
longest sequence), and 5 optimizer steps' losses must agree within 1e-5
relative in fp32. label_semantic_roles also fetches its Viterbi path,
which must be the JAX package's.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.dataset as jdataset
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import stacked_lstm as jstacked_lstm
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import stacked_lstm as tstacked_lstm

J = dict(fluid=jfluid, unique_name=junique_name, stacked_lstm=jstacked_lstm)
T = dict(fluid=tfluid, unique_name=tunique_name, stacked_lstm=tstacked_lstm)
LOSS_RTOL = 1e-5
STEPS = 5


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _truncated(reader, n, cols):
    """Each sample's sequence columns cut to their first n items, so the
    batches keep one padded length (one compile in the JAX package)."""
    def r():
        for s in reader():
            yield tuple(v[:n] if i in cols else v for i, v in enumerate(s))
    return r


# -- understand_sentiment (tests/test_book_understand_sentiment.py) -----------

EMB_DIM, HID_DIM, STACKED_NUM, CLASS_DIM = 16, 16, 3, 2


def _convolution_net(fluid, data, input_dim):
    L = fluid.layers
    emb = L.embedding(input=data, size=[input_dim, EMB_DIM])
    conv_3 = fluid.nets.sequence_conv_pool(input=emb, num_filters=HID_DIM,
                                           filter_size=3, act='tanh',
                                           pool_type='sqrt')
    conv_4 = fluid.nets.sequence_conv_pool(input=emb, num_filters=HID_DIM,
                                           filter_size=4, act='tanh',
                                           pool_type='sqrt')
    return L.fc(input=[conv_3, conv_4], size=CLASS_DIM, act='softmax')


def _stacked_lstm_net(fluid, data, input_dim):
    L = fluid.layers
    emb = L.embedding(input=data, size=[input_dim, EMB_DIM])
    fc1 = L.fc(input=emb, size=HID_DIM)
    lstm1, _ = L.dynamic_lstm(input=fc1, size=HID_DIM, use_peepholes=False)
    inputs = [fc1, lstm1]
    for i in range(2, STACKED_NUM + 1):
        fc = L.fc(input=inputs, size=HID_DIM)
        lstm, _ = L.dynamic_lstm(input=fc, size=HID_DIM,
                                 is_reverse=(i % 2) == 0,
                                 use_peepholes=False)
        inputs = [fc, lstm]
    fc_last = L.sequence_pool(input=inputs[0], pool_type='max')
    lstm_last = L.sequence_pool(input=inputs[1], pool_type='max')
    return L.fc(input=[fc_last, lstm_last], size=CLASS_DIM, act='softmax')


def _sentiment(net, lr):
    def chapter(m):
        fluid = m['fluid']
        L = fluid.layers
        data = L.data(name='words', shape=[1], dtype='int64', lod_level=1)
        label = L.data(name='label', shape=[1], dtype='int64')
        dict_len = len(jdataset.imdb.word_dict())
        if net == 'model':
            _, avg_cost, _ = m['stacked_lstm'].train_network(
                data, label, dict_len, emb_dim=EMB_DIM, hid_dim=HID_DIM,
                stacked_num=STACKED_NUM)
        else:
            build = _convolution_net if net == 'conv' else _stacked_lstm_net
            predict = build(fluid, data, dict_len)
            avg_cost = L.mean(L.cross_entropy(input=predict, label=label))
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
        return ['words', 'label'], avg_cost, [], \
            lambda d: _truncated(d.imdb.train(), 16, (0,)), 8
    return chapter


# -- recommender (tests/test_book_recommender.py) -----------------------------

REC_EMB = 16


def _recommender(m):
    fluid = m['fluid']
    L = fluid.layers
    ml = jdataset.movielens

    def tower(ids, vocab, name):
        emb = L.embedding(input=ids, size=[vocab, REC_EMB],
                          param_attr=fluid.ParamAttr(name=name))
        return L.fc(input=emb, size=REC_EMB)

    names = ['user_id', 'gender_id', 'age_id', 'job_id', 'movie_id',
             'category_id', 'movie_title', 'score']
    uid, gender, age, job, mid = [
        L.data(name=n, shape=[1], dtype='int64') for n in names[:5]]
    cats = L.data(name='category_id', shape=[1], dtype='int64', lod_level=1)
    title = L.data(name='movie_title', shape=[1], dtype='int64',
                   lod_level=1)
    score = L.data(name='score', shape=[1], dtype='float32')
    usr = L.concat([tower(uid, ml.max_user_id() + 1, 'user_emb'),
                    tower(gender, 2, 'gender_emb'),
                    tower(age, len(ml.age_table), 'age_emb'),
                    tower(job, ml.max_job_id() + 1, 'job_emb')], axis=-1)
    usr_feat = L.fc(input=usr, size=32, act='tanh')
    mov_emb = tower(mid, ml.max_movie_id() + 1, 'movie_emb')
    cat_emb = L.embedding(cats, size=[len(ml.movie_categories()), REC_EMB])
    cat_pool = L.reshape(L.sequence_pool(cat_emb, 'sum'),
                         shape=[-1, REC_EMB])
    title_emb = L.embedding(title, size=[len(ml.get_movie_title_dict()),
                                         REC_EMB])
    title_pool = L.reshape(L.sequence_pool(title_emb, 'sum'),
                           shape=[-1, REC_EMB])
    mov = L.concat([mov_emb, cat_pool, title_pool], axis=-1)
    mov_feat = L.fc(input=mov, size=32, act='tanh')
    predict = L.scale(L.cos_sim(X=usr_feat, Y=mov_feat), scale=5.0)
    avg_cost = L.mean(L.square_error_cost(input=predict, label=score))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)

    def reader(d):
        def r():
            for s in d.movielens.train()():
                yield s[:7] + ([s[7]],)
        return r
    return names, avg_cost, [], reader, 16


# -- label_semantic_roles (tests/test_book_label_semantic_roles.py) -----------

WORD_DIM, MARK_DIM, HIDDEN_DIM, DEPTH = 8, 4, 32, 2
SRL_NAMES = ['word_data', 'ctx_n2_data', 'ctx_n1_data', 'ctx_0_data',
             'ctx_p1_data', 'ctx_p2_data', 'verb_data', 'mark_data']


def _db_lstm(fluid, word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
             mark, word_dict_len, pred_dict_len, mark_dict_len,
             label_dict_len):
    L = fluid.layers
    predicate_embedding = L.embedding(input=predicate,
                                      size=[pred_dict_len, WORD_DIM])
    mark_embedding = L.embedding(input=mark, size=[mark_dict_len, MARK_DIM])
    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    emb_layers = [L.embedding(input=x, size=[word_dict_len, WORD_DIM],
                              param_attr=fluid.ParamAttr(name='emb'))
                  for x in word_input]
    emb_layers.append(predicate_embedding)
    emb_layers.append(mark_embedding)
    hidden_0 = L.sums(input=[L.fc(input=emb, size=HIDDEN_DIM, act='tanh')
                             for emb in emb_layers])
    lstm_0, _ = L.dynamic_lstm(input=hidden_0, size=HIDDEN_DIM,
                               use_peepholes=False)
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, DEPTH):
        mix_hidden = L.sums(input=[
            L.fc(input=input_tmp[0], size=HIDDEN_DIM, act='tanh'),
            L.fc(input=input_tmp[1], size=HIDDEN_DIM, act='tanh')])
        lstm, _ = L.dynamic_lstm(input=mix_hidden, size=HIDDEN_DIM,
                                 is_reverse=(i % 2) == 1,
                                 use_peepholes=False)
        input_tmp = [mix_hidden, lstm]
    return L.sums(input=[
        L.fc(input=input_tmp[0], size=label_dict_len, act='tanh'),
        L.fc(input=input_tmp[1], size=label_dict_len, act='tanh')])


def _label_semantic_roles(m):
    fluid = m['fluid']
    L = fluid.layers
    word_dict, verb_dict, label_dict = jdataset.conll05.get_dict()
    feeds = [L.data(name=n, shape=[1], dtype='int64', lod_level=1)
             for n in SRL_NAMES]
    target = L.data(name='target', shape=[1], dtype='int64', lod_level=1)
    feature_out = _db_lstm(fluid, feeds[0], feeds[6], feeds[1], feeds[2],
                           feeds[3], feeds[4], feeds[5], feeds[7],
                           len(word_dict), len(verb_dict), 2,
                           len(label_dict))
    crf_cost = L.linear_chain_crf(input=feature_out, label=target,
                                  param_attr=fluid.ParamAttr(name='crfw'))
    avg_cost = L.mean(crf_cost)
    fluid.optimizer.SGD(learning_rate=0.05).minimize(avg_cost)
    crf_decode = L.crf_decoding(input=feature_out,
                                param_attr=fluid.ParamAttr(name='crfw'))
    return SRL_NAMES + ['target'], avg_cost, [crf_decode], \
        lambda d: _truncated(d.conll05.test(), 10, range(9)), 4


CHAPTERS = {
    'understand_sentiment-conv': _sentiment('conv', 0.005),
    'understand_sentiment-stacked_lstm': _sentiment('lstm', 0.01),
    'recommender': _recommender,
    'label_semantic_roles': _label_semantic_roles,
    'models.stacked_lstm': _sentiment('model', 0.01),
}


def _chapter(m, dataset, name):
    fluid = m['fluid']
    with m['unique_name'].guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 42
        with fluid.program_guard(main, startup):
            feed_names, loss, extra, reader, bs = CHAPTERS[name](m)
    return dict(main=main, startup=startup, loss=loss, extra=extra,
                batches=fluid.batch(reader(dataset), bs, drop_last=True),
                feeder=fluid.DataFeeder(feed_list=feed_names,
                                        place=fluid.CPUPlace(),
                                        program=main))


def _run_chapter(c, fluid, init=None):
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    if init is None:
        exe.run(c['startup'], scope=scope)
        init = {v.name: np.array(scope.find_var(v.name))
                for v in c['startup'].list_vars() if v.persistable}
    else:
        fluid.io.load_numpy_params(scope, init, fluid.CPUPlace(),
                                   program=c['main'])
    losses, extras, feeds = [], [], []
    for i, data in enumerate(c['batches']()):
        if i == STEPS:
            break
        feed = c['feeder'].feed(data)
        feeds.append(feed)
        out = exe.run(c['main'], feed=feed,
                      fetch_list=[c['loss']] + c['extra'], scope=scope)
        losses.append(float(np.asarray(out[0])))
        extras.append([np.asarray(o) for o in out[1:]])
    return init, losses, extras, feeds


@pytest.mark.parametrize('name', sorted(CHAPTERS))
def test_sequence_chapter_steps_match_jax(name):
    jc = _chapter(J, jdataset, name)
    tc = _chapter(T, tfluid.dataset, name)
    assert tc['main'].to_string() == jc['main'].to_string()
    init, want, jextra, jfeeds = _run_chapter(jc, jfluid)
    _, got, textra, tfeeds = _run_chapter(tc, tfluid, init=init)
    assert len(got) == len(want) == STEPS
    for jf, tf in zip(jfeeds, tfeeds):
        assert sorted(tf) == sorted(jf)
        for n in jf:
            w = jf[n].numpy() if hasattr(jf[n], 'lod') else jf[n]
            g = tf[n].numpy() if hasattr(tf[n], 'lod') else tf[n]
            np.testing.assert_array_equal(g, w)
            if hasattr(jf[n], 'lod'):
                assert tf[n].lod() == jf[n].lod()
    assert any(hasattr(v, 'lod') for v in tfeeds[0].values())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.isfinite(got).all()
    for je, te in zip(jextra, textra):
        for w, g in zip(je, te):
            np.testing.assert_array_equal(g, w)
