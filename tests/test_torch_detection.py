"""The detection ops and layers, the port against the JAX package on the
CPU.

- Each of the 15 op types as one-op programs (CASES, modelled on
  tests/test_detection_ops.py's cases, through test_torch_sequence's
  harness): the same seeded numpy inputs in both packages, the forward
  outputs and the registered input grads (from a seeded cotangent)
  within 1e-5, integer outputs equal; each second run in the port reads
  nothing back to the host (a captured segment's rule). rpn_target_assign
  draws its sample, so it is held by its properties.
- Ties that must pick the JAX package's indices: equal scores in
  multiclass_nms and generate_proposals, equal CE in ssd_loss's and
  mine_hard_examples' mining, equal IoU in bipartite_match.
- Each of the 15 layers of layers/detection.py (and
  polygon_box_transform) builds the JAX package's Program text.
- An SSD network at a tiny width (chip_smoke.ssd_build: 64 px, three
  maps, 5 classes) trains 3 Momentum steps within 1e-4 of the JAX
  package; then detection_output and detection_map on its test clone
  equal the JAX package's.
- tests/test_detection_ops.py's behaviour cases, in the port.
"""
import types

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from test_torch_sequence import (_compare, _cotangents, _forward_of, _run,
                                 _second_run_guarded)

TOL = 1e-5
STEP_TOL = 1e-4
UNIQUE = {jfluid: junique_name, tfluid: tunique_name}


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


def _r(seed):
    return np.random.RandomState(seed)


def _boxes(seed, *lead, scale=1.0, size=0.4):
    """Valid [x1, y1, x2, y2] boxes: a corner in [0, scale) and a size up
    to size x scale."""
    r = _r(seed)
    xy = r.rand(*lead, 2) * scale
    wh = (0.05 + r.rand(*lead, 2) * size) * scale
    return np.concatenate([xy, xy + wh], -1).astype('float32')


def _case(op_type, inputs, outputs, check=(), targets=None, attrs=None):
    return dict(type=op_type, inputs=inputs, outputs=outputs,
                check=list(check), attrs=attrs or {},
                targets=targets or [next(iter(outputs.values()))[0]])


def _grid_priors(n=4):
    g = np.arange(n) / n
    gx, gy = np.meshgrid(g, g)
    p = np.stack([gx.ravel(), gy.ravel(), gx.ravel() + 1.0 / n,
                  gy.ravel() + 1.0 / n], -1)
    return p.astype('float32')


def _ssd_inputs(seed, B=2, C=3, G=3, tie=False):
    r = _r(seed)
    priors = _grid_priors()
    M = len(priors)
    gt = _boxes(seed + 1, B, G, size=0.3)
    labels = r.randint(1, C, (B, G)).astype('int64')
    labels[0, 2] = -1                      # padding rows (label -1)
    labels[1, 1:] = -1
    conf = np.zeros((B, M, C), 'float32') if tie else \
        r.randn(B, M, C).astype('float32')
    return {'Location': (r.randn(B, M, 4) * 0.1).astype('float32'),
            'Confidence': conf, 'GtBox': gt, 'GtLabel': labels,
            'PriorBox': priors,
            'PriorBoxVar': np.full((M, 4), 0.1, 'float32')}


def _nms_inputs(seed, B=2, C=3, N=20, tie=False):
    r = _r(seed)
    boxes = _boxes(seed, B, N, size=0.5)
    boxes[:, 1] = boxes[:, 0] + 0.01       # a near duplicate of box 0
    scores = r.dirichlet(np.ones(C), (B, N)).transpose(0, 2, 1)
    scores = scores.astype('float32')
    if tie:
        scores[:, 1, :8] = 0.5             # equal scores, disjoint or not
        scores[:, 2] = scores[:, 1]
    return {'BBoxes': boxes, 'Scores': scores}


def _anchors(H, W, A, stride=8.0):
    a = np.zeros((H, W, A, 4), 'float32')
    for y in range(H):
        for x in range(W):
            for k in range(A):
                s = stride * (1 + k)
                cx, cy = (x + 0.5) * stride, (y + 0.5) * stride
                a[y, x, k] = [cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2]
    return a


def _proposal_inputs(seed, tie=False):
    r = _r(seed)
    A, H, W = 3, 4, 5
    scores = r.rand(1, A, H, W).astype('float32')
    if tie:
        scores[0, :, :2] = 0.75
    return {'Scores': scores,
            'BboxDeltas': (r.randn(1, 4 * A, H, W) * 0.2).astype('float32'),
            'ImInfo': np.array([[30.0, 38.0, 1.0]], 'float32'),
            'Anchors': _anchors(H, W, A),
            'Variances': np.ones((H, W, A, 4), 'float32')}


def _cases():
    c = {}
    for norm in (True, False):
        c['iou_similarity%s' % ('' if norm else '-pixels')] = _case(
            'iou_similarity', {'X': _boxes(1, 5, scale=1 if norm else 20),
                               'Y': _boxes(2, 6, scale=1 if norm else 20)},
            {'Out': ['out']}, ['X', 'Y'], attrs={'box_normalized': norm})
    feat = np.zeros((1, 8, 4, 5), 'float32')
    img = np.zeros((1, 3, 64, 80), 'float32')
    c['prior_box'] = _case(
        'prior_box', {'Input': feat, 'Image': img},
        {'Boxes': ['boxes'], 'Variances': ['var']},
        attrs={'min_sizes': [16.0], 'max_sizes': [32.0],
               'aspect_ratios': [1.0, 2.0, 3.0], 'flip': True, 'clip': True,
               'variances': [0.1, 0.1, 0.2, 0.2], 'step_w': 0.0,
               'step_h': 0.0, 'offset': 0.5})
    c['prior_box-steps'] = _case(
        'prior_box', {'Input': feat, 'Image': img},
        {'Boxes': ['boxes'], 'Variances': ['var']},
        attrs={'min_sizes': [8.0, 20.0], 'max_sizes': [],
               'aspect_ratios': [2.0], 'flip': False, 'clip': False,
               'variances': [0.2, 0.2, 0.1, 0.1], 'step_w': 12.0,
               'step_h': 14.0, 'offset': 0.25})
    priors = _boxes(3, 5)
    c['box_coder-encode'] = _case(
        'box_coder', {'PriorBox': priors,
                      'PriorBoxVar': np.full((5, 4), 0.1, 'float32'),
                      'TargetBox': _boxes(4, 3)},
        {'OutputBox': ['out']}, ['TargetBox'],
        attrs={'code_type': 'encode_center_size'})
    c['box_coder-decode'] = _case(
        'box_coder', {'PriorBox': priors,
                      'PriorBoxVar': np.full((5, 4), 0.2, 'float32'),
                      'TargetBox': (_r(5).randn(3, 5, 4) * 0.5).astype(
                          'float32')},
        {'OutputBox': ['out']}, ['TargetBox'],
        attrs={'code_type': 'decode_center_size'})
    c['box_coder-decode-pixels-novar'] = _case(
        'box_coder', {'PriorBox': _boxes(6, 5, scale=30),
                      'TargetBox': (_r(7).randn(2, 5, 4) * 0.5).astype(
                          'float32')},
        {'OutputBox': ['out']}, ['TargetBox'],
        attrs={'code_type': 'decode_center_size', 'box_normalized': False})
    nms_attrs = {'score_threshold': 0.05, 'nms_top_k': 10, 'keep_top_k': 12,
                 'nms_threshold': 0.4, 'normalized': True,
                 'background_label': 0}
    for tie in (False, True):
        c['multiclass_nms%s' % ('-ties' if tie else '')] = _case(
            'multiclass_nms', _nms_inputs(8, tie=tie),
            {'Out': ['out'], 'ValidCount': ['count']}, attrs=nms_attrs)
    c['multiclass_nms-pad-nobg'] = _case(
        'multiclass_nms', _nms_inputs(9, C=2, N=6),
        {'Out': ['out'], 'ValidCount': ['count']},
        attrs=dict(nms_attrs, nms_top_k=3, keep_top_k=10,
                   background_label=-1))
    dist = _r(10).rand(2, 3, 7).astype('float32')
    c['bipartite_match'] = _case(
        'bipartite_match', {'DistMat': dist},
        {'ColToRowMatchIndices': ['idx'], 'ColToRowMatchDist': ['dist']})
    c['bipartite_match-per_prediction'] = _case(
        'bipartite_match', {'DistMat': dist},
        {'ColToRowMatchIndices': ['idx'], 'ColToRowMatchDist': ['dist']},
        attrs={'match_type': 'per_prediction', 'dist_threshold': 0.4})
    tied = np.array([[[0.5, 0.9, 0.9, 0.1], [0.9, 0.9, 0.2, 0.9],
                      [0.3, 0.3, 0.3, 0.3]]], 'float32')
    c['bipartite_match-ties'] = _case(
        'bipartite_match', {'DistMat': tied},
        {'ColToRowMatchIndices': ['idx'], 'ColToRowMatchDist': ['dist']},
        attrs={'match_type': 'per_prediction', 'dist_threshold': 0.3})
    c['bipartite_match-2d'] = _case(
        'bipartite_match', {'DistMat': dist[0]},
        {'ColToRowMatchIndices': ['idx'], 'ColToRowMatchDist': ['dist']})
    c['target_assign'] = _case(
        'target_assign', {'X': _r(11).randn(2, 3, 4).astype('float32'),
                          'MatchIndices': np.array(
                              [[1, -1, 0, 2, -1, 1], [-1, -1, 2, 0, 0, 1]],
                              'int32')},
        {'Out': ['out'], 'OutWeight': ['w']}, attrs={'mismatch_value': -7})
    c['anchor_generator'] = _case(
        'anchor_generator', {'Input': np.zeros((1, 8, 3, 5), 'float32')},
        {'Anchors': ['anchors'], 'Variances': ['var']},
        attrs={'anchor_sizes': [32.0, 64.0],
               'aspect_ratios': [0.5, 1.0, 2.0], 'stride': [16.0, 12.0],
               'variances': [0.1, 0.1, 0.2, 0.2], 'offset': 0.5})
    for tie in (False, True):
        c['ssd_loss%s' % ('-ties' if tie else '')] = _case(
            'ssd_loss', _ssd_inputs(12, tie=tie), {'Loss': ['loss']},
            ['Location', 'Confidence'],
            attrs={'background_label': 0, 'overlap_threshold': 0.3,
                   'neg_pos_ratio': 3.0, 'loc_loss_weight': 1.0,
                   'conf_loss_weight': 1.0, 'normalize': True})
    ssd = _ssd_inputs(13)
    ssd.pop('PriorBoxVar')
    c['ssd_loss-novar-sum'] = _case(
        'ssd_loss', ssd, {'Loss': ['loss']}, ['Location', 'Confidence'],
        attrs={'overlap_threshold': 0.5, 'neg_pos_ratio': 1.0,
               'loc_loss_weight': 2.0, 'normalize': False})
    r = _r(14)
    match = r.randint(-1, 3, (2, 10)).astype('int32')
    match[:, :2] = -1
    c['mine_hard_examples'] = _case(
        'mine_hard_examples',
        {'ClsLoss': r.rand(2, 10).astype('float32'), 'MatchIndices': match,
         'MatchDist': r.rand(2, 10).astype('float32')},
        {'NegMask': ['neg'], 'UpdatedMatchIndices': ['upd']},
        attrs={'neg_pos_ratio': 1.0, 'neg_dist_threshold': 0.7})
    tied = match.copy()
    tied[:, :7] = -1                       # 7 negatives, a budget of 3
    c['mine_hard_examples-ties'] = _case(
        'mine_hard_examples',
        {'ClsLoss': np.full((2, 10), 0.5, 'float32'), 'MatchIndices': tied},
        {'NegMask': ['neg'], 'UpdatedMatchIndices': ['upd']},
        attrs={'neg_pos_ratio': 1.0})
    c['mine_hard_examples-hard'] = _case(
        'mine_hard_examples',
        {'ClsLoss': r.rand(2, 10).astype('float32'), 'MatchIndices': match,
         'LocLoss': r.rand(2, 10).astype('float32')},
        {'NegMask': ['neg'], 'UpdatedMatchIndices': ['upd']},
        attrs={'mining_type': 'hard_example', 'sample_size': 3})
    x = _r(15).randn(2, 3, 8, 9).astype('float32')
    rois = np.array([[0, 0, 16, 18], [4, 2, 10, 12], [-3, -2, 6, 5],
                     [10, 8, 30, 20], [5, 5, 5.5, 5.2]], 'float32')
    bidx = np.array([0, 1, 1, 0, 1], 'int32')
    c['roi_align'] = _case(
        'roi_align', {'X': x, 'ROIs': rois, 'RoisBatchIdx': bidx},
        {'Out': ['out']}, ['X'],
        attrs={'pooled_height': 3, 'pooled_width': 2, 'spatial_scale': 0.5,
               'sampling_ratio': 2})
    c['roi_align-one-image'] = _case(
        'roi_align', {'X': x[:1], 'ROIs': rois * 0.5},
        {'Out': ['out']}, ['X'],
        attrs={'pooled_height': 2, 'pooled_width': 4, 'spatial_scale': 1.0,
               'sampling_ratio': -1})
    c['roi_pool'] = _case(
        'roi_pool', {'X': x, 'ROIs': rois, 'RoisBatchIdx': bidx},
        {'Out': ['out']}, ['X'],
        attrs={'pooled_height': 3, 'pooled_width': 2, 'spatial_scale': 0.5,
               'sampling_ratio': 1})
    c['roi_pool-one-image'] = _case(
        'roi_pool', {'X': x[:1], 'ROIs': rois}, {'Out': ['out']}, ['X'],
        attrs={'pooled_height': 4, 'pooled_width': 3, 'spatial_scale': 1.0,
               'sampling_ratio': 1})
    for tie in (False, True):
        c['generate_proposals%s' % ('-ties' if tie else '')] = _case(
            'generate_proposals', _proposal_inputs(16, tie=tie),
            {'RpnRois': ['rois'], 'RpnRoiProbs': ['probs'],
             'RpnRoisNum': ['num']},
            attrs={'pre_nms_topN': 30, 'post_nms_topN': 10,
                   'nms_thresh': 0.5, 'min_size': 2.0})
    c['polygon_box_transform'] = _case(
        'polygon_box_transform',
        {'Input': _r(17).randn(2, 4, 3, 5).astype('float32')},
        {'Output': ['out']})
    det = np.zeros((2, 6, 6), 'float32')
    det[..., 0] = [[1, 2, 1, 3, -1, 2], [3, 3, 1, -1, -1, 2]]
    det[..., 1] = _r(18).rand(2, 6)
    det[0, 3, 1] = det[0, 1, 1]            # a score tie
    det[..., 2:] = _boxes(19, 2, 6, size=0.5)
    gt = np.zeros((2, 3, 5), 'float32')
    gt[..., 0] = [[1, 2, 3], [3, 1, 0]]
    gt[..., 1:] = det[:, :3, 2:] + _r(20).randn(2, 3, 4) * 0.02
    gt[1, 2, 1:] = 0                       # a padding row (all zero)
    for ap in ('integral', '11point'):
        c['detection_map-' + ap] = _case(
            'detection_map', {'DetectRes': det, 'Label': gt},
            {'MAP': ['map']},
            attrs={'class_num': 4, 'overlap_threshold': 0.5,
                   'ap_type': ap, 'background_label': 0,
                   'evaluate_difficult': True})
    gt6 = np.concatenate([gt[..., :1], np.zeros_like(gt[..., :1]),
                          gt[..., 1:]], -1)
    gt6[0, 1, 1] = 1                       # a difficult gt
    c['detection_map-difficult'] = _case(
        'detection_map', {'DetectRes': det, 'Label': gt6},
        {'MAP': ['map']},
        attrs={'class_num': 4, 'overlap_threshold': 0.5,
               'ap_type': 'integral', 'background_label': -1,
               'evaluate_difficult': False})
    return c


CASES = _cases()


def test_cases_cover_every_detection_op_type_but_the_drawn_one():
    types = {c['type'] for c in CASES.values()}
    from paddle_tpu.ops import detection_ops as jdet
    from paddle_tpu import registry as jregistry
    from paddle_tpu_torch import registry as tregistry
    jtypes = {t for t, d in jregistry._REGISTRY.items()
              if not t.endswith('_grad') and
              getattr(d.emit, '__module__', '') == jdet.__name__}
    assert len(jtypes) == 15
    assert jtypes - types == {'rpn_target_assign'}
    assert jtypes <= set(tregistry._REGISTRY)
    for t in jtypes:
        assert jregistry.has_op(t + '_grad') == tregistry.has_op(t + '_grad')


@pytest.mark.parametrize('name', sorted(CASES))
def test_op_forward_and_grads_match_jax(name, monkeypatch):
    case = CASES[name]
    cots = _cotangents(case, _forward_of(jfluid, case)) \
        if case['check'] else {}
    want, = _run(jfluid, case, cots=cots)
    got, again = _run(tfluid, case, cots=cots,
                      guard=_second_run_guarded(monkeypatch))
    assert any(n.endswith('@GRAD') for n in got) == bool(case['check'])
    _compare(want, got, TOL)
    _compare(got, again, 0.0)


def test_tie_cases_pick_the_jax_indices():
    """The tie cases are ties: equal kept scores in multiclass_nms,
    equal proposal scores, equal CE, equal mining losses, equal IoU; and
    each took the JAX package's indices (test_op_forward_and_grads_
    match_jax compares the integer outputs exactly)."""
    got, = _run(tfluid, CASES['multiclass_nms-ties'])
    kept = got['out'][got['out'][..., 0] >= 0]
    assert (np.unique(kept[:, 1], return_counts=True)[1] > 1).any()
    got, = _run(tfluid, CASES['generate_proposals-ties'])
    assert (got['probs'][0] == np.float32(0.75)).sum() >= 2
    case = CASES['mine_hard_examples-ties']
    got, = _run(tfluid, case)
    match = case['inputs']['MatchIndices']
    for b in range(2):
        negs = np.flatnonzero(match[b] < 0)
        budget = int((match[b] >= 0).sum())
        assert 0 < budget < len(negs)
        np.testing.assert_array_equal(np.flatnonzero(got['neg'][b]),
                                      negs[:budget])
    got, = _run(tfluid, CASES['bipartite_match-ties'])
    np.testing.assert_array_equal(got['idx'][0], [1, 0, 2, 1])


# -- rpn_target_assign, by its properties ---------------------------------------

def _rpn_program(fluid, anchors, batch, fg_frac, with_valid):
    prog = fluid.Program()
    with UNIQUE[fluid].guard(), fluid.program_guard(prog, fluid.Program()):
        L = fluid.layers
        a = L.assign(anchors)
        g = L.data(name='g', shape=[3, 4], dtype='float32')
        gv = L.data(name='gv', shape=[3], dtype='float32') \
            if with_valid else None
        labels, tgt = L.rpn_target_assign(
            a, g, gt_valid=gv, rpn_batch_size_per_im=batch,
            rpn_fg_fraction=fg_frac, rpn_positive_overlap=0.7,
            rpn_negative_overlap=0.3)
    return prog, [labels, tgt]


@pytest.mark.parametrize('with_valid', [False, True])
def test_rpn_target_assign_holds_the_jax_properties(with_valid):
    """Both packages' draws hold chip_smoke.rpn_label_properties (at most
    the batch labelled, at most the fg fraction fg, fg only over the
    positive overlap or at a gt's best anchor and each gt's best fg, bg
    only under the negative overlap, each target a best gt's box); the
    port's second run draws anew (the executor's generator) and holds
    them too."""
    anchors = _anchors(5, 6, 3, stride=8.0)
    gts = _boxes(21, 2, 3, scale=40.0, size=0.5)
    gts[1, 2] = [0, 0, 10, 10]
    valid = np.ones((2, 3), 'float32')
    if with_valid:
        valid[1, 1:] = 0
    feed = {'g': gts}
    if with_valid:
        feed['gv'] = valid
    batch, fg_frac = 24, 0.25
    draws = []
    for fluid in (jfluid, tfluid, tfluid):
        prog, fetch = _rpn_program(fluid, anchors, batch, fg_frac,
                                   with_valid)
        exe = fluid.Executor(fluid.CPUPlace())
        labels, tgt = (np.asarray(v) for v in exe.run(
            prog, feed=feed, fetch_list=fetch, scope=fluid.Scope()))
        assert labels.shape == (2, 90) and labels.dtype == np.int32
        chip_smoke.rpn_label_properties(fluid.__name__, anchors, gts, labels,
                                        tgt, batch, fg_frac, 0.7, 0.3,
                                        valid=valid)
        assert (labels == 1).any() and (labels == 0).any()
        draws.append(labels)
    assert not np.array_equal(draws[1], draws[2])


# -- the layers' Program text ------------------------------------------------------

def _layer_programs(fluid):
    """Each detection layer in a Program of its own: {name: text}."""
    L = fluid.layers
    out = {}

    def prog(name, build):
        p = fluid.Program()
        with UNIQUE[fluid].guard(), fluid.program_guard(p, fluid.Program()):
            build()
        out[name] = p.to_string()

    def data(name, shape, dtype='float32'):
        return L.data(name=name, shape=shape, dtype=dtype)

    prog('prior_box', lambda: L.prior_box(
        data('f', [8, 4, 4]), data('i', [3, 32, 32]), [8.0], [16.0],
        aspect_ratios=[1.0, 2.0], flip=True, clip=True))
    prog('box_coder', lambda: L.box_coder(
        data('p', [4]), data('v', [4]), data('t', [5, 4]),
        code_type='decode_center_size'))
    prog('iou_similarity', lambda: L.iou_similarity(data('x', [4]),
                                                    data('y', [4])))
    prog('multiclass_nms', lambda: L.multiclass_nms(
        data('b', [6, 4]), data('s', [3, 6]), 0.05, 4, 5))
    prog('detection_output', lambda: L.detection_output(
        data('l', [6, 4]), data('s', [3, 6]), data('p', [4]),
        data('v', [4])))
    prog('bipartite_match', lambda: L.bipartite_match(
        data('d', [3, 6]), match_type='per_prediction'))
    prog('target_assign', lambda: L.target_assign(
        data('x', [3, 4]), data('m', [6], 'int32'), mismatch_value=-1))
    prog('anchor_generator', lambda: L.anchor_generator(
        data('f', [8, 4, 4]), [32.0, 64.0], [0.5, 1.0, 2.0]))
    prog('ssd_loss', lambda: L.ssd_loss(
        data('l', [6, 4]), data('c', [6, 3]), data('gb', [2, 4]),
        data('gl', [2], 'int64'), data('p', [4]), data('v', [4])))
    prog('roi_align', lambda: L.roi_align(
        data('x', [3, 8, 8]), data('r', [4]), 2, 2, 0.5, 2))
    prog('roi_pool', lambda: L.roi_pool(
        data('x', [3, 8, 8]), data('r', [4]), 2, 2, 0.5))
    prog('generate_proposals', lambda: L.generate_proposals(
        data('s', [3, 4, 4]), data('d', [12, 4, 4]), data('i', [3]),
        data('a', [4]), data('v', [4])))
    prog('rpn_target_assign', lambda: L.rpn_target_assign(
        data('a', [4]), data('g', [2, 4]), data('gv', [2])))
    prog('detection_map', lambda: L.detection_map(
        data('d', [5, 6]), data('g', [3, 5]), 4, ap_version='11point'))
    prog('multi_box_head', lambda: L.multi_box_head(
        [data('f1', [8, 4, 4]), data('f2', [8, 2, 2]),
         data('f3', [8, 1, 1])], data('i', [3, 32, 32]), base_size=32,
        num_classes=3, aspect_ratios=[[2.0], [2.0, 3.0], [2.0]],
        min_ratio=20, max_ratio=90))
    prog('polygon_box_transform', lambda: L.polygon_box_transform(
        data('q', [4, 3, 3])))
    return out


def test_layers_build_the_jax_program_text():
    from paddle_tpu.layers import detection as jdetection
    from paddle_tpu_torch.layers import detection as tdetection
    assert tdetection.__all__ == jdetection.__all__
    assert tfluid.layers.detection is tdetection
    assert set(jdetection.__all__) <= set(tfluid.layers.__all__)
    jtext, ttext = _layer_programs(jfluid), _layer_programs(tfluid)
    assert set(jtext) == set(jdetection.__all__) | {'polygon_box_transform'}
    for name in jtext:
        assert ttext[name] == jtext[name], name


# -- an SSD network at a tiny width --------------------------------------------------

def _ssd(fluid, w, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with UNIQUE[fluid].guard(), fluid.program_guard(main, startup):
        out = chip_smoke.ssd_build(w)(fluid)
    return main, startup, out


def _ssd_init(main, seed):
    rng = np.random.RandomState(seed)
    init = {}
    for p in main.global_block().all_parameters():
        fan_in = int(np.prod(p.shape[1:])) if len(p.shape) > 1 else 1
        scale = 0.0 if p.name.endswith('.b_0') or 'batch_norm' in p.name \
            else np.sqrt(2.0 / max(fan_in, 1))
        init[p.name] = (rng.randn(*p.shape) * scale).astype('float32')
        if 'batch_norm' in p.name and p.name.endswith('.w_0'):
            init[p.name] = np.ones(p.shape, 'float32')
    return init


def _ssd_run(fluid, w, feeds, decode_feed):
    main, startup, out = _ssd(fluid, w)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = _ssd_init(main, 3)
    if fluid is tfluid:
        fluid.io.load_numpy_params(scope, init, fluid.CPUPlace(),
                                   program=main)
    else:
        for n, v in init.items():
            scope.set_var(n, v)
    losses = [float(np.asarray(exe.run(
        main, feed=f, fetch_list=[out['loss']], scope=scope)[0]))
        for f in feeds]
    state = {v.name: np.array(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    test, fetch = chip_smoke.ssd_test_program(
        types.SimpleNamespace(fluid=fluid, main=main, pred=out), w)
    dets, count, m_ap = (np.asarray(v) for v in exe.run(
        test, feed=decode_feed, fetch_list=fetch[-3:], scope=scope))
    return losses, state, dets, count, m_ap


def test_tiny_ssd_trains_and_decodes_like_jax():
    """chip_smoke.ssd_build at SSD_TINY (64 px, three maps, 5 classes,
    batch 2): 3 Momentum steps with L2 decay within 1e-4 of the JAX
    package (losses relative, every persistable absolute); then the test
    clone's detection_output rows (label, score, box) and valid counts
    and detection_map's mAP equal to the JAX package's (scores and boxes
    within 1e-5)."""
    w = chip_smoke.SSD_TINY
    feeds = [chip_smoke.ssd_train_feed(chip_smoke.ssd_feed(
        np.random.RandomState(30 + i), w)) for i in range(3)]
    decode_feed = chip_smoke.ssd_feed(np.random.RandomState(40), w)
    jl, js, jd, jc, jm = _ssd_run(jfluid, w, feeds, decode_feed)
    tl, ts, td, tc, tm = _ssd_run(tfluid, w, feeds, decode_feed)
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert sorted(ts) == sorted(js)
    for n, want in js.items():
        np.testing.assert_allclose(ts[n], want, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=n)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])
    np.testing.assert_allclose(td[..., 1:], jd[..., 1:], rtol=TOL, atol=TOL)
    assert (jc > 0).all()
    np.testing.assert_allclose(tm, jm, rtol=TOL, atol=TOL)


# -- tests/test_detection_ops.py's behaviour cases, in the port -------------------

def _port_run(build, feeds):
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        fetches = build(tfluid.layers)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(prog, feed=feeds,
                                            fetch_list=list(fetches),
                                            scope=scope)]


def test_nms_suppresses_overlaps_and_pads():
    boxes = np.array([[[0.0, 0.0, 0.4, 0.4], [0.01, 0.01, 0.41, 0.41],
                       [0.6, 0.6, 0.9, 0.9], [0.0, 0.6, 0.2, 0.8]]],
                     'float32')
    scores = np.zeros((1, 2, 4), 'float32')
    scores[0, 1] = [0.9, 0.8, 0.7, 0.05]

    def build(L):
        b = L.data(name='b', shape=[4, 4], dtype='float32')
        s = L.data(name='s', shape=[2, 4], dtype='float32')
        return L.multiclass_nms(b, s, score_threshold=0.1, nms_top_k=4,
                                keep_top_k=16, nms_threshold=0.5)
    out, count = _port_run(build, {'b': boxes, 's': scores})
    assert out.shape == (1, 16, 6) and count[0] == 2
    np.testing.assert_allclose(out[0, :2, 1], [0.9, 0.7], atol=1e-6)
    np.testing.assert_allclose(out[0, 0, 2:], boxes[0, 0], atol=1e-6)
    assert (out[0, 2:] == -1).all()


def test_ssd_loss_ignores_padded_gt_rows():
    M, C, G = 4, 3, 3
    p0 = np.array([[0, 0, .5, .5], [.5, 0, 1, .5],
                   [0, .5, .5, 1], [.5, .5, 1, 1]], 'float32')
    gtb = np.zeros((2, G, 4), 'float32')
    gtl = np.full((2, G), -1, 'int64')
    gtb[0, 0] = [0.02, 0.02, 0.48, 0.49]
    gtl[0, 0] = 1

    def build(L):
        loc = L.data(name='loc', shape=[M, 4], dtype='float32')
        conf = L.data(name='conf', shape=[M, C], dtype='float32')
        gb = L.data(name='gb', shape=[G, 4], dtype='float32')
        gl = L.data(name='gl', shape=[G], dtype='int64')
        return [L.ssd_loss(loc, conf, gb, gl, L.assign(p0),
                           neg_pos_ratio=0.0)]
    l, = _port_run(build, {'loc': np.zeros((2, M, 4), 'float32'),
                           'conf': np.zeros((2, M, C), 'float32'),
                           'gb': gtb, 'gl': gtl})
    l = l.ravel()
    assert abs(l[0] - np.log(3)) < 0.1 and l[1] == 0.0


def test_roi_ops_on_ramps_spikes_and_borders():
    """roi_align of an x-ramp reads each bin's mean x; of a constant map,
    the constant to the border; roi_pool finds a spike in a wide bin and
    does not leak across bins."""
    ramp = np.broadcast_to(np.arange(8, dtype='float32'),
                           (1, 1, 8, 8)).copy()

    def align(L):
        x = L.data(name='x', shape=[1, 8, 8], dtype='float32')
        r = L.data(name='r', shape=[4], dtype='float32')
        return [L.roi_align(x, r, 2, 2, sampling_ratio=2),
                L.roi_align(x, r, 8, 8, sampling_ratio=2)]
    out, _ = _port_run(align, {'x': ramp, 'r': np.array(
        [[0, 0, 8, 8], [2, 2, 6, 6]], 'float32')})
    np.testing.assert_allclose(out[0, 0, 0], [1.5, 5.5], atol=1e-4)
    np.testing.assert_allclose(out[1, 0, 0], [2.5, 4.5], atol=1e-4)
    _, flat = _port_run(align, {'x': np.ones((1, 1, 8, 8), 'float32'),
                                'r': np.array([[0, 0, 8, 8]], 'float32')})
    np.testing.assert_allclose(flat, 1.0, atol=1e-6)

    def pool(L):
        x = L.data(name='x', shape=[1, 16, 16], dtype='float32')
        r = L.data(name='r', shape=[4], dtype='float32')
        return [L.roi_pool(x, r, 2, 2)]
    feat = np.zeros((1, 1, 16, 16), 'float32')
    feat[0, 0, 0, 0] = 100.0
    feat[0, 0, :, 9] = 9.0
    out, = _port_run(pool, {'x': feat, 'r': np.array([[0, 0, 16, 16],
                                                      [0, 0, 4, 4]],
                                                     'float32')})
    assert out[0, 0, 0, 0] == 100.0 and out[0, 0, 0, 1] == 9.0
    assert out[1, 0, 1, 1] == 0.0


def test_generate_proposals_keeps_the_winner_and_clips():
    A, H, W = 2, 2, 2
    anchors = np.zeros((H, W, A, 4), 'float32')
    for y in range(H):
        for x in range(W):
            base = [x * 8.0, y * 8.0, x * 8.0 + 8, y * 8.0 + 8]
            anchors[y, x, 0] = base
            anchors[y, x, 1] = [b + 0.5 for b in base]
    scores = np.full((1, A, H, W), 0.1, 'float32')
    scores[0, 0, 0, 0] = 0.9
    scores[0, 1, 0, 0] = 0.8

    def build(L):
        s = L.data(name='s', shape=[A, H, W], dtype='float32')
        d = L.data(name='d', shape=[4 * A, H, W], dtype='float32')
        info = L.data(name='i', shape=[3], dtype='float32')
        return L.generate_proposals(
            s, d, info, L.assign(anchors),
            L.assign(np.ones((H, W, A, 4), 'float32')), pre_nms_top_n=8,
            post_nms_top_n=4, nms_thresh=0.5, min_size=1.0)
    rois, probs, num = _port_run(build, {
        's': scores, 'd': np.zeros((1, 4 * A, H, W), 'float32'),
        'i': np.array([[16.0, 16.0, 1.0]], 'float32')})
    assert rois.shape == (1, 4, 4) and probs[0, 0] == np.float32(0.9)
    np.testing.assert_allclose(rois[0, 0], [0, 0, 8, 8], atol=1e-5)
    assert not np.any(np.isclose(probs[0, 1:], 0.8))
    assert num[0] == 4          # one of each near-duplicate pair


def test_a_prior_grid_is_built_once_per_shape():
    """prior_box keeps its grid on the op: a second run at the same shape
    reuses the tensor, another shape builds its own."""
    prog = tfluid.Program()
    with tfluid.program_guard(prog, tfluid.Program()):
        feat = tfluid.layers.data(name='f', shape=[4, -1, -1],
                                  dtype='float32')
        img = tfluid.layers.data(name='i', shape=[3, 32, 32],
                                 dtype='float32')
        boxes, _ = tfluid.layers.prior_box(feat, img, [8.0])
    exe = tfluid.Executor(tfluid.CPUPlace())
    outs = []
    for hw in (4, 4, 2):
        outs.append(exe.run(prog, feed={
            'f': np.zeros((1, 4, hw, hw), 'float32'),
            'i': np.zeros((1, 3, 32, 32), 'float32')},
            fetch_list=[boxes], return_numpy=False)[0])
    op, = [o for o in prog.global_block().ops if o.type == 'prior_box']
    assert len(op._device_constants) == 2
    assert outs[0].data_ptr() == outs[1].data_ptr()
    assert tuple(outs[2].shape) == (2, 2, 1, 4)
