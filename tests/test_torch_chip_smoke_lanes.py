"""chip_smoke.py's two lanes on the CPU: the rule by which main()'s blocks
and the second lane's units share the card's memory (card_share,
_take_share), across processes through the shares file; the second
lane running its units as their shares fit and pickling their results,
or exiting 1 on a phase's failure; and the shares each block and unit
names."""
import inspect
import os
import pickle
import re
import subprocess
import sys
import time

import pytest

import chip_smoke

BUDGET = chip_smoke.CARD_BUDGET_GB


def _state(held=None, want=None):
    return {'held': dict(held or {}), 'want': dict(want or {}), 'next': {}}


def test_a_share_fits_beside_what_is_held_and_main_goes_first():
    """main()'s lane takes a share that fits beside what is held, or
    alone, and is recorded as waiting where it does not; the second lane
    takes one only beside the most main() holds, waits for or takes with
    its next block."""
    take = chip_smoke._take_share
    st = _state()
    assert take(st, '1:serving', 12, True, next_gb=30)
    assert st['next'] == {'1': 30}
    # beside the next block's 30, not the 12 held now
    assert not take(st, '2:mp1', BUDGET - 29, False)
    assert take(st, '2:mp1', BUDGET - 30, False)
    assert st['held'] == {'1:serving': 12, '2:mp1': BUDGET - 30}
    # main()'s next block does not fit beside mp1: it waits
    st['held'].pop('1:serving')
    assert not take(st, '1:resnet', 54, True)
    assert st['want'] == {'1:resnet': 54}
    # the second lane starts nothing that would not fit beside that wait
    st['held'].pop('2:mp1')
    assert not take(st, '2:fl1', BUDGET - 53, False)
    assert take(st, '1:resnet', 54, True) and st['want'] == {}
    assert st['next'] == {}
    assert take(st, '2:ps', BUDGET - 54, False)
    assert not take(st, '2:on1', 1, False)
    # a share larger than the budget runs alone, in either lane
    st = _state()
    assert take(st, '1:big', BUDGET + 1, True)
    st = _state()
    assert take(st, '2:big', BUDGET + 1, False)
    st = _state(want={'1:resnet': 54})
    assert not take(st, '2:big', BUDGET + 1, False)


HOLDER = r'''
import sys, time
sys.path.insert(0, %(root)r)
import chip_smoke
path = %(path)r
key = '%%d:hold' %% __import__('os').getpid()
assert chip_smoke._shares_io(
    path, lambda st: chip_smoke._take_share(st, key, %(gb)r, False))
print('held', flush=True)
time.sleep(%(hold)r)
chip_smoke._shares_io(path, lambda st: st['held'].pop(key, None))
'''


def _holder(tmp_path, gb, hold):
    path = str(tmp_path / 'shares.json')
    proc = subprocess.Popen(
        [sys.executable, '-c', HOLDER % dict(
            root=os.path.dirname(chip_smoke.__file__), path=path, gb=gb,
            hold=hold)], stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == 'held'
    return path, proc


def test_card_share_waits_for_another_process_and_drops_a_dead_ones(
        tmp_path, monkeypatch, capsys):
    """main()'s block waits while another process holds what leaves it no
    room, calling check() as it waits, and takes its share once that
    process lets go; a share of a process that has exited is dropped."""
    path, proc = _holder(tmp_path, BUDGET - 10, 1.5)
    monkeypatch.setenv(chip_smoke.SHARES_ENV, path)
    checks = []
    t0 = time.perf_counter()
    with chip_smoke.card_share('resnet', 54, check=lambda: checks.append(1)):
        waited = time.perf_counter() - t0
        state = chip_smoke._shares_io(path, lambda st: dict(st['held']))
    proc.wait()
    assert waited >= 1.0 and checks
    assert list(state) == ['%d:resnet' % os.getpid()]
    assert chip_smoke._shares_io(path, lambda st: st) == _state()
    assert 'card share resnet released' in capsys.readouterr().out

    # a holder killed with its share still recorded
    path, proc = _holder(tmp_path, BUDGET, 60)
    proc.kill()
    proc.wait()
    t0 = time.perf_counter()
    with chip_smoke.card_share('resnet', 54):
        assert time.perf_counter() - t0 < 1.0


def test_a_failed_second_lane_ends_the_wait(tmp_path, monkeypatch):
    """check() raising (the second lane has failed) ends main()'s wait
    with that error."""
    path, proc = _holder(tmp_path, BUDGET, 30)
    monkeypatch.setenv(chip_smoke.SHARES_ENV, path)

    def check():
        raise chip_smoke.PhaseError('the second lane failed (exit 1)')
    try:
        with pytest.raises(chip_smoke.PhaseError, match='second lane'):
            with chip_smoke.card_share('resnet', 54, check=check):
                pass
    finally:
        proc.kill()
        proc.wait()


def test_without_the_shares_file_a_block_does_not_wait(monkeypatch):
    monkeypatch.delenv(chip_smoke.SHARES_ENV, raising=False)
    with chip_smoke.card_share('resnet', 10 * BUDGET):
        pass


def _go(path):
    chip_smoke._shares_io(path, lambda st: st.update(go=True))


def _settled(path):
    """The shares file's state with main()'s go and the claims taken
    out."""
    st = chip_smoke._shares_io(path, lambda st: dict(st))
    st.pop('go', None)
    return st.pop('claimed'), st


def test_the_second_lane_runs_its_units_and_pickles_their_results(
        tmp_path, monkeypatch, capsys):
    """A worker of the second lane starts nothing before main() says go,
    then runs every unit once its share fits (here: after another
    process lets go of the card), pickles the results of all of them,
    and releases every share; a unit's PhaseError exits 1 with the error
    on stderr and no results."""
    path, proc = _holder(tmp_path, BUDGET, 1.0)
    monkeypatch.setenv(chip_smoke.SHARES_ENV, path)
    ran = []

    def unit(name, **out):
        def fn():
            ran.append(name)
            return out
        return fn
    monkeypatch.setattr(chip_smoke, 'second_lane_units', lambda *a: [
        ('ck1', unit('ck1', ck1=1, op_worst=0.5)),
        ('ps', unit('ps', ps1=2, ps2=3))])
    st = _state()
    assert chip_smoke._claim_unit(st, 7, ['ck1', 'ps']) is None
    assert st['held'] == {}
    _go(path)
    out = str(tmp_path / 'lane.pkl')
    assert chip_smoke.second_lane('model', str(tmp_path), out) == 0
    proc.wait()
    assert ran == ['ck1', 'ps']
    with open(out, 'rb') as f:
        assert pickle.load(f) == {'ck1': 1, 'op_worst': 0.5, 'ps1': 2,
                                  'ps2': 3}
    assert _settled(path) == (['ck1', 'ps'], _state())

    def fails():
        raise chip_smoke.PhaseError('phase ps1 failed: AssertionError: x')
    path = str(tmp_path / 'shares2.json')
    monkeypatch.setenv(chip_smoke.SHARES_ENV, path)
    _go(path)
    monkeypatch.setattr(chip_smoke, 'second_lane_units', lambda *a: [
        ('ps', fails), ('on1', unit('on1', on1=1))])
    out = str(tmp_path / 'lane2.pkl')
    assert chip_smoke.second_lane('model', str(tmp_path), out) == 1
    assert not os.path.exists(out)
    assert 'phase ps1 failed' in capsys.readouterr().err
    assert _settled(path) == (['ps'], _state())


def test_two_workers_take_each_unit_once(tmp_path, monkeypatch):
    """Two workers of the second lane run beside each other: each unit
    runs once, in one of them, and two units run at once only where
    their shares fit together."""
    path = str(tmp_path / 'shares.json')
    monkeypatch.setenv(chip_smoke.SHARES_ENV, path)
    _go(path)
    names = list(chip_smoke.SECOND_SHARES_GB)
    st = chip_smoke._shares_io(path, lambda st: st)
    first = chip_smoke._claim_unit(st, 1, names)
    second = chip_smoke._claim_unit(st, 2, names)
    assert first == names[0] and second not in (first, None)
    assert chip_smoke.SECOND_SHARES_GB[first] + \
        chip_smoke.SECOND_SHARES_GB[second] <= BUDGET
    st['held'].clear()
    while chip_smoke._claim_unit(st, 1, names):
        st['held'].clear()
    assert sorted(st['claimed']) == sorted(names)
    assert chip_smoke._claim_unit(st, 2, names) == ''


def test_every_block_and_unit_names_its_share():
    """main()'s blocks are MAIN_SHARES_GB's, each once; the second lane's
    units are SECOND_SHARES_GB's in its order and give main() the
    results it reads; every unit fits beside at least one block."""
    src = inspect.getsource(chip_smoke.main)
    blocks = re.findall(r"with block\('(\w+)'\):", src)
    assert blocks == list(chip_smoke.MAIN_SHARES_GB)
    units = [name for name, _ in chip_smoke.second_lane_units('m', 'w', None)]
    assert units == list(chip_smoke.SECOND_SHARES_GB)
    for key in ('ck1', 'opt_worst', 'op_worst', 'ps1', 'ps2', 'on1', 'fl1',
                'fl2', 'mp1', 'mp2', 'pp1', 'sv1'):
        assert "lane['%s']" % key in src
    smallest = min(chip_smoke.MAIN_SHARES_GB.values())
    for gb in chip_smoke.SECOND_SHARES_GB.values():
        assert smallest + gb <= BUDGET
