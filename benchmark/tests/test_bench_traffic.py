import json
import shutil

from benchmark import run, spec
from benchmark.reference.tokenizer import Tokenizer
from benchmark.tests.cells import TINY
from benchmark.traffic import Traffic, lengths

TOK = Tokenizer()


def _requests(mix, seed, n=40):
    t = Traffic(mix, seed, TOK)
    return [t.request(i) for i in range(n)]


def test_same_seed_same_requests_other_seed_same_work():
    mix = spec.cell("rwkv4-430m-q8.chat").traffic
    a, b, c = _requests(mix, 4100000001), _requests(mix, 4100000001), _requests(mix, 5300000007)
    assert a == b
    assert [r.text for r in a] != [r.text for r in c]
    assert [r.seed for r in a] != [r.seed for r in c]
    # every seed asks for the same work: sizes, order and checked places
    for key in ("drawn_tokens", "max_tokens", "tau", "checked"):
        assert [getattr(r, key) for r in a] == [getattr(r, key) for r in c]


def test_prompts_encode_to_their_drawn_length():
    mix = spec.cell("rwkv4-430m-q8.longprompt").traffic
    for r in _requests(mix, 2 ** 40 + 3, n=24):
        assert len(TOK.encode(r.text)) == r.drawn_tokens


def test_cycle_lengths_are_clipped_lognormal_quantiles():
    d = {"median": 96, "sigma": 0.7, "min": 16, "max": 512}
    v = lengths(d, 16)
    assert v == sorted(v) and v[7] <= 96 <= v[8] and min(v) >= 16 and max(v) <= 512
    assert lengths({"median": 8, "sigma": 0.4, "min": 4, "max": 16}, 16)[0] == 4


def test_new_mix_and_cell_need_no_code(tmp_path):
    """A traffic file, a limits file and a workloads entry are all a new cell
    needs: the harness finds them by name and runs them."""
    here = tmp_path / "benchmark"
    for sub in ("configs", "families", "traffic", "checks", "layer_metrics"):
        shutil.copytree(spec.HERE / sub, here / sub)
    bench = spec.load_benchmark()
    mix = json.loads((spec.HERE / "traffic" / "chat.json").read_text())
    mix.update(prompt_tokens={"median": 40, "sigma": 0.3, "min": 8, "max": 64},
               output_tokens={"median": 12, "sigma": 0.3, "min": 4, "max": 20})
    (here / "traffic" / "brief.json").write_text(json.dumps(mix))
    shutil.copy(spec.HERE / "checks" / "rwkv4-430m-q8.chat.json", here / "checks" / "rwkv4-430m-q8.brief.json")
    bench["workloads"].append({"name": "rwkv4-430m-q8.brief", "config": "rwkv4-430m-q8",
                               "traffic": "brief", "chips": 1, "why": "a test"})
    cell = spec.cell("rwkv4-430m-q8.brief", bench=bench, here=here)
    assert cell.traffic["prompt_tokens"]["max"] == 64
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    cell.config.update(TINY)
    cell.config["engine"]["max_streams"] = 4
    cell.traffic.update(clients=4)
    out = run.run_cell(cell, 77, 1.0, trace=False, device="cpu")
    assert out["correct"] and out["attempted"] > 4
