"""The machine_translation chapter and the contrib decoders, the port
against the JAX package on the CPU.

- machine_translation as tests/test_book_machine_translation.py builds
  it (an embedding -> fc -> dynamic_gru encoder, the per-position
  attention decoder, Adam), at its small widths, in both packages under
  the same names; the JAX package's initial persistables are copied into
  the port, both are fed the same batches of dataset.wmt14 through
  fluid.batch + DataFeeder's LoD branch, and 5 steps' losses agree
  within 1e-4. Then that test's unrolled beam decoder (_decode_program)
  at beam 1 and beam 4 from the trained scope: the same sentences and
  scores within 1e-4, and beam 4's best score at least beam 1's in
  every row. The port alone trains the chapter to its threshold.
- tests/test_contrib_decoder.py's copy task: the TrainingDecoder (a
  DynamicRNN, so recurrent and its grad) 5 Adam steps within 1e-4 of the
  JAX package, its StateCell updater a layers.gru_unit, then the
  BeamSearchDecoder (beam_search and beam_gather) from that scope: the
  same ids and scores within 1e-4. The port alone learns the task, and
  StateCell keeps the JAX package's guards.
- dataset.wmt14 and wmt16 serve the JAX package's samples bit for bit;
  their convert() writes the JAX package's shard files byte for byte.
"""
import itertools
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.dataset as jdataset
import paddle_tpu_torch as tfluid
from paddle_tpu.contrib.decoder import beam_search_decoder as jdecoder
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.contrib.decoder import beam_search_decoder as tdecoder

STEP_TOL = 1e-4
STEPS = 5
DICT_SIZE = 200
WORD_DIM = 16
HID = 16
BATCH = 4
SRC_T, TRG_T = 8, 9


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


def _attr(fluid, name):
    return fluid.ParamAttr(name=name)


def encoder(fluid, src):
    """The chapter's encoder with its shared parameter names."""
    L = fluid.layers
    emb = L.embedding(input=src, size=[DICT_SIZE, WORD_DIM],
                      param_attr=_attr(fluid, 'src_emb_w'))
    fc1 = L.fc(input=emb, size=HID * 3, param_attr=_attr(fluid, 'enc_fc_w'),
               bias_attr=_attr(fluid, 'enc_fc_b'))
    return L.dynamic_gru(input=fc1, size=HID,
                         param_attr=_attr(fluid, 'enc_gru_w'),
                         bias_attr=_attr(fluid, 'enc_gru_b'))


def _head(fluid, emb, encoded, flatten):
    """query projection, attention over the encoder states, the tanh
    state and the softmax over the target dict."""
    L = fluid.layers
    kw = dict(num_flatten_dims=2) if flatten else {}
    q = L.fc(input=emb, size=HID, param_attr=_attr(fluid, 'dec_q_w'),
             bias_attr=_attr(fluid, 'dec_q_b'), **kw)
    att = L.softmax(L.matmul(q, encoded, transpose_y=True))
    ctx = L.matmul(att, encoded)
    state = L.concat([emb, ctx], axis=-1)
    hidden = L.fc(input=state, size=HID, act='tanh',
                  param_attr=_attr(fluid, 'dec_h_w'),
                  bias_attr=_attr(fluid, 'dec_h_b'), **kw)
    return L.fc(input=hidden, size=DICT_SIZE, act='softmax',
                param_attr=_attr(fluid, 'dec_o_w'),
                bias_attr=_attr(fluid, 'dec_o_b'), **kw)


def train_program(fluid):
    L = fluid.layers
    src = L.data(name='src_word_id', shape=[1], dtype='int64', lod_level=1)
    trg = L.data(name='target_language_word', shape=[1], dtype='int64',
                 lod_level=1)
    trg_next = L.data(name='target_language_next_word', shape=[1],
                      dtype='int64', lod_level=1)
    encoded = encoder(fluid, src)
    trg_emb = L.embedding(input=trg, size=[DICT_SIZE, WORD_DIM],
                          param_attr=_attr(fluid, 'trg_emb_w'))
    predict = _head(fluid, trg_emb, encoded, flatten=False)
    cost = L.cross_entropy(input=predict, label=trg_next)
    cost.seq_lens = trg_next.seq_lens
    cost.lod_level = 1
    avg_cost = L.mean(L.sequence_pool(cost, 'average'))
    fluid.optimizer.Adam(learning_rate=0.02).minimize(avg_cost)
    return [src, trg, trg_next], avg_cost


def decode_program(fluid, beam_size, trg_t=TRG_T):
    """tests/test_book_machine_translation.py's _decode_program."""
    L = fluid.layers
    src = L.data(name='src_word_id', shape=[1], dtype='int64', lod_level=1)
    init_ids = L.data(name='init_ids', shape=[beam_size], dtype='int64')
    init_scores = L.data(name='init_scores', shape=[beam_size],
                         dtype='float32')
    encoded = encoder(fluid, src)
    ids, scores = init_ids, init_scores
    step_ids, step_parents = [], []
    for _ in range(trg_t):
        emb = L.embedding(input=L.unsqueeze(ids, axes=[2]),
                          size=[DICT_SIZE, WORD_DIM],
                          param_attr=_attr(fluid, 'trg_emb_w'))
        probs = _head(fluid, emb, encoded, flatten=True)
        logp = L.log(L.scale(probs, scale=1.0, bias=1e-9))
        ids, scores, parents = L.beam_search(ids, scores, logp,
                                             beam_size=beam_size, end_id=0)
        step_ids.append(ids)
        step_parents.append(parents)
    return list(L.beam_search_decode(L.stack(step_ids, axis=0),
                                     L.stack(step_parents, axis=0), scores))


def _programs(fluid, build, seed=11):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = build(fluid)
    return main, startup, out


def _init_from_jax(jstart, jscope, tprog, tscope):
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jstart.list_vars() if v.persistable}
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tprog)


def _decode_feed(feed, beam):
    init_scores = np.full((BATCH, beam), -1e9, 'float32')
    init_scores[:, 0] = 0.0
    return {'src_word_id': feed['src_word_id'],
            'init_ids': np.ones((BATCH, beam), 'int64'),
            'init_scores': init_scores}


def test_machine_translation_steps_and_beam_decode_match_jax():
    progs = {}
    for fluid, dataset in ((jfluid, jdataset), (tfluid, tfluid.dataset)):
        main, startup, (feeds, loss) = _programs(fluid, train_program)
        feeder = fluid.DataFeeder(feed_list=feeds, place=fluid.CPUPlace(),
                                  program=main)
        batches = fluid.batch(dataset.wmt14.train(DICT_SIZE), BATCH,
                              drop_last=True)
        progs[fluid.__name__] = (main, startup, loss, [
            feeder.feed(b) for b in itertools.islice(batches(), STEPS)])
    jmain, jstart, jloss, jfeeds = progs['paddle_tpu']
    tmain, _, tloss, tfeeds = progs['paddle_tpu_torch']
    assert tmain.to_string() == jmain.to_string()
    for jf, tf in zip(jfeeds, tfeeds):
        for n in jf:
            np.testing.assert_array_equal(tf[n].numpy(), jf[n].numpy())
            assert tf[n].lod() == jf[n].lod()
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    _init_from_jax(jstart, jscope, tmain, tscope)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    want = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0])) for f in jfeeds]
    got = [float(np.asarray(texe.run(tmain, feed=f, fetch_list=[tloss],
                                      scope=tscope)[0])) for f in tfeeds]
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)

    # the unrolled beam decoder from the trained scopes
    pad = tfluid.executor.pad_lod_to_batch
    src = tfeeds[0]['src_word_id']
    padded = pad(src.numpy(), src.lod()[0])
    best = {}
    for beam in (1, 4):
        feed = _decode_feed({'src_word_id': padded}, beam)
        res = []
        for fluid, scope in ((jfluid, jscope), (tfluid, tscope)):
            main, _, fetch = _programs(fluid, lambda f: decode_program(
                f, beam))
            res.append([np.asarray(v) for v in fluid.Executor(
                fluid.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                      scope=scope)])
        (jsent, jsc), (tsent, tsc) = res
        assert tsent.shape == (BATCH, beam, TRG_T)
        np.testing.assert_array_equal(tsent.astype(jsent.dtype), jsent)
        np.testing.assert_allclose(tsc, jsc, rtol=STEP_TOL, atol=STEP_TOL)
        best[beam] = tsc[:, 0]
    assert (best[4] >= best[1] - 1e-5).all(), (best[1], best[4])


def test_machine_translation_trains_to_the_chapter_threshold():
    """The JAX chapter's contract on the port: one padded batch of wmt14,
    the loss under 2.0 within 150 Adam steps."""
    main, startup, (feeds, loss) = _programs(tfluid, train_program)
    samples = list(itertools.islice(
        tfluid.dataset.wmt14.train(DICT_SIZE)(), BATCH))
    feed = tfluid.DataFeeder(feed_list=feeds, place=tfluid.CPUPlace(),
                             program=main).feed(samples)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(150):
        last = float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]))
        if last < 2.0:
            break
    assert np.isfinite(last) and last < 2.0, last


# -- the contrib decoders (tests/test_contrib_decoder.py's copy task) ---------------

DICT, WORD, CELL_HID, T_SRC, T_TRG, BEAM, END = 12, 16, 32, 5, 5, 2, 1


def _copy_encoder(fluid):
    L = fluid.layers
    src = L.data(name='src', shape=[T_SRC], dtype='int64')
    emb = L.embedding(input=L.unsqueeze(src, axes=[2]), size=[DICT, WORD],
                      param_attr=_attr(fluid, 'src_emb_w'))
    h = L.fc(input=emb, size=CELL_HID, act='tanh', num_flatten_dims=2,
             param_attr=_attr(fluid, 'enc_w'), bias_attr=_attr(fluid, 'enc_b'))
    return L.reduce_mean(h, dim=1)


def _state_cell(fluid, dec, context):
    """The copy task's cell; its updater steps a layers.gru_unit over
    the word's projection."""
    L = fluid.layers
    cell = dec.StateCell(inputs={'x': None},
                         states={'h': dec.InitState(init=context,
                                                    need_reorder=True)},
                         out_state='h')

    @cell.state_updater
    def updater(cell):
        word = cell.get_input('x')
        prev_h = cell.get_state('h')
        flat = len(word.shape) - 1
        gates = L.fc(input=word, size=3 * CELL_HID, num_flatten_dims=flat,
                     param_attr=_attr(fluid, 'cell_wx'),
                     bias_attr=False)
        if flat > 1:
            # [B, beam, ...]: gru_unit takes rows
            gates = L.reshape(gates, shape=[-1, 3 * CELL_HID])
            h, _, _ = L.gru_unit(gates, L.reshape(prev_h, [-1, CELL_HID]),
                                 3 * CELL_HID,
                                 param_attr=_attr(fluid, 'cell_wh'),
                                 bias_attr=_attr(fluid, 'cell_b'))
            h = L.reshape(h, shape=[-1, BEAM, CELL_HID])
        else:
            h, _, _ = L.gru_unit(gates, prev_h, 3 * CELL_HID,
                                 param_attr=_attr(fluid, 'cell_wh'),
                                 bias_attr=_attr(fluid, 'cell_b'))
        cell.set_state('h', h)
    return cell


def copy_train_program(fluid, dec):
    L = fluid.layers
    cell = _state_cell(fluid, dec, _copy_encoder(fluid))
    trg = L.data(name='trg', shape=[T_TRG], dtype='int64')
    trg_emb = L.embedding(input=L.unsqueeze(trg, axes=[2]),
                          size=[DICT, WORD], param_attr=_attr(fluid,
                                                              'trg_emb_w'))
    decoder = dec.TrainingDecoder(cell)
    with decoder.block():
        cur = decoder.step_input(trg_emb)
        decoder.state_cell.compute_state(inputs={'x': cur})
        score = L.fc(input=decoder.state_cell.get_state('h'), size=DICT,
                     act='softmax',
                     param_attr=_attr(fluid, 'beam_search_decoder_0_out_w'),
                     bias_attr=_attr(fluid, 'beam_search_decoder_0_out_b'))
        decoder.state_cell.update_states()
        decoder.output(score)
    probs = decoder()
    label = L.data(name='label', shape=[T_TRG, 1], dtype='int64')
    avg = L.mean(L.cross_entropy(input=probs, label=label))
    fluid.optimizer.Adam(learning_rate=5e-3).minimize(avg)
    return avg


def copy_decode_program(fluid, dec):
    L = fluid.layers
    cell = _state_cell(fluid, dec, _copy_encoder(fluid))
    init_ids = L.data(name='init_ids', shape=[BEAM], dtype='int64')
    init_scores = L.data(name='init_scores', shape=[BEAM], dtype='float32')
    bs = dec.BeamSearchDecoder(
        state_cell=cell, init_ids=init_ids, init_scores=init_scores,
        target_dict_dim=DICT, word_dim=WORD, max_len=T_TRG, beam_size=BEAM,
        end_id=END, sparse_emb=False, name='beam_search_decoder_0')
    bs._embedding_param = 'trg_emb_w'
    bs.decode()
    return list(bs())


def _copy_batch(rng, bs=16):
    src = rng.randint(2, DICT - 2, (bs, T_SRC)).astype('int64')
    trg_out = (src + 1) % DICT
    trg_in = np.concatenate([np.full((bs, 1), 2, 'int64'), trg_out[:, :-1]],
                            axis=1)
    return {'src': src, 'trg': trg_in, 'label': trg_out[:, :, None]}


MODS = {'paddle_tpu': jdecoder, 'paddle_tpu_torch': tdecoder}


def test_contrib_decoder_matches_jax():
    built = {}
    for fluid in (jfluid, tfluid):
        dec = MODS[fluid.__name__]
        built[fluid.__name__] = (
            _programs(fluid, lambda f: copy_train_program(f, dec)),
            _programs(fluid, lambda f: copy_decode_program(f, dec)))
    (jmain, jstart, jloss), (jdec, _, jfetch) = built['paddle_tpu']
    (tmain, _, tloss), (tdec, _, tfetch) = built['paddle_tpu_torch']
    assert tmain.to_string() == jmain.to_string()
    assert tdec.to_string() == jdec.to_string()
    ops = [op.type for op in tmain.global_block().ops]
    assert 'recurrent' in ops and 'recurrent_grad' in ops
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    _init_from_jax(jstart, jscope, tmain, tscope)
    rng = np.random.RandomState(0)
    feeds = [_copy_batch(rng) for _ in range(STEPS)]
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    want = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0])) for f in feeds]
    got = [float(np.asarray(texe.run(tmain, feed=f, fetch_list=[tloss],
                                      scope=tscope)[0])) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)
    src = _copy_batch(rng, bs=4)['src']
    sc0 = np.zeros((4, BEAM), 'float32')
    sc0[:, 1:] = -1e9
    feed = {'src': src, 'init_ids': np.full((4, BEAM), 2, 'int64'),
            'init_scores': sc0}
    wid, wsc = jexe.run(jdec, feed=feed, fetch_list=jfetch, scope=jscope)
    gid, gsc = texe.run(tdec, feed=feed, fetch_list=tfetch, scope=tscope)
    assert np.asarray(gid).shape == (4, BEAM, T_TRG)
    np.testing.assert_array_equal(np.asarray(gid), np.asarray(wid))
    np.testing.assert_allclose(gsc, wsc, rtol=STEP_TOL, atol=STEP_TOL)


def test_contrib_decoder_copy_task_trains():
    """The JAX package's property on the port: 250 steps halve the loss,
    and the beam decode gives valid ids and finite scores."""
    main, startup, loss = _programs(
        tfluid, lambda f: copy_train_program(f, tdecoder))
    dmain, _, fetch = _programs(
        tfluid, lambda f: copy_decode_program(f, tdecoder))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = [float(np.asarray(exe.run(main, feed=_copy_batch(rng),
                                       fetch_list=[loss], scope=scope)[0]))
              for _ in range(250)]
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    sc0 = np.zeros((4, BEAM), 'float32')
    sc0[:, 1:] = -1e9
    ids, scores = exe.run(dmain, feed={
        'src': _copy_batch(rng, 4)['src'],
        'init_ids': np.full((4, BEAM), 2, 'int64'), 'init_scores': sc0},
        fetch_list=fetch, scope=scope)
    assert np.isfinite(scores).all() and ((ids >= 0) & (ids < DICT)).all()


def test_state_cell_guards_match_jax():
    for fluid in (jfluid, tfluid):
        dec = MODS[fluid.__name__]
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            boot = fluid.layers.data(name='b', shape=[4], dtype='float32')
            st = dec.InitState(init_boot=boot, shape=[-1, 4], value=0.0)
            cell = dec.StateCell(inputs={'x': None}, states={'h': st},
                                 out_state='h')
            with pytest.raises(ValueError,
                               match='compute_state must run inside a '
                                     'decoder'):
                cell.compute_state(inputs={'x': boot})
            with pytest.raises(ValueError, match='Unknown state h'):
                cell.get_state('h')
            with pytest.raises(ValueError, match='init_boot must be '
                                                 'provided'):
                dec.InitState(shape=[4])


# -- the datasets -----------------------------------------------------------------------

@pytest.mark.parametrize('name,args', [
    ('wmt14.train', (DICT_SIZE,)), ('wmt14.test', (30000,)),
    ('wmt16.train', (300, 400)), ('wmt16.validation', (300, 400)),
    ('wmt16.test', (300, 400))])
def test_wmt_samples_are_the_jax_packages(name, args):
    mod, split = name.split('.')
    want = list(getattr(getattr(jdataset, mod), split)(*args)())
    got = list(getattr(getattr(tfluid.dataset, mod), split)(*args)())
    assert got == want
    src, trg, nxt = got[0]
    assert 3 <= len(src) <= 11 and trg[0] == 0 and nxt[-1] == 1


def test_wmt_dicts_and_convert(tmp_path):
    assert tfluid.dataset.wmt14.get_dict(50) == jdataset.wmt14.get_dict(50)
    assert tfluid.dataset.wmt16.get_dict('de', 50, reverse=True) == \
        jdataset.wmt16.get_dict('de', 50, reverse=True)
    assert tfluid.dataset.wmt14.N == 30000
    assert tfluid.dataset.wmt16.fetch() is None
    for mod in ('wmt14', 'wmt16'):
        tdir, jdir = tmp_path / ('t' + mod), tmp_path / ('j' + mod)
        getattr(tfluid.dataset, mod).convert(str(tdir))
        getattr(jdataset, mod).convert(str(jdir))
        names = sorted(os.listdir(tdir))
        assert names and names == sorted(os.listdir(jdir))
        for n in names:
            assert (tdir / n).read_bytes() == (jdir / n).read_bytes(), n
