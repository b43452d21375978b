"""The port's CLIs (``cli/generate.py``, ``cli/eval_ppl.py``) on the golden
reference-schema checkpoint ``tests/golden/e8p12`` with ``--device cpu``,
held to the JAX package's CLIs on the same flags: the printed ids equal
(greedy, float32; no tokenizer here, so both fall back to the prompt's
bytes), and ppl within 1e-2 relative in the same JSON keys.

One known difference from the reference is kept: the JAX generate CLI's
first, untimed run drops ``--kv-quantized`` (its ``cli/generate.py:87-90``
against ``:98-104``); the port passes it to both runs. The printed ids
come from the second run in both, so they agree.
"""
import json
import os

import pytest
import torch

from quip_for_all_tpu.cli import eval_ppl as j_eval_ppl
from quip_for_all_tpu.cli import generate as j_generate

from quip_for_all_tpu_torch.cli import eval_ppl, generate

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker, so that a parallel
    test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "e8p12")


def _out(capsys, main, argv):
    main(argv)
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("extra", [[], ["--kv-quantized"],
                                   ["--stream", "--stream-chunk", "3"]])
def test_generate_cli_matches_jax(capsys, extra):
    argv = ["--model-path", GOLDEN, "--prompt", "Hello, QuIP#",
            "--max-new-tokens", "8", "--temperature", "0", "--cache-len",
            "64", "--dtype", "float32"] + extra
    want = _out(capsys, j_generate.main, argv)
    got = _out(capsys, generate.main, argv + ["--device", "cpu"])
    assert got == want
    if "--stream" not in extra:
        assert len(json.loads(got[-1])) == len("Hello, QuIP#") + 8


@pytest.mark.parametrize("batch_size", [1, 2])
def test_eval_ppl_cli_matches_jax(capsys, batch_size):
    argv = ["--model-path", GOLDEN, "--dataset", "synthetic", "--nsamples",
            "4", "--seqlen", "32", "--batch-size", str(batch_size)]
    want = json.loads(_out(capsys, j_eval_ppl.main, argv)[-1])
    got = json.loads(_out(capsys, eval_ppl.main, argv + ["--device",
                                                        "cpu"])[-1])
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if k != "ppl"} == {
        k: v for k, v in want.items() if k != "ppl"}
    assert abs(got["ppl"] - want["ppl"]) <= 1e-2 * want["ppl"]


@pytest.mark.parametrize("argv,match", [
    (["--sp", "2", "--dataset", "synthetic"], "queue 1 item 8"),
    (["--dataset", "wikitext2-test"], "not ported")])
def test_eval_ppl_cli_refuses_what_is_not_ported(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        eval_ppl.main(["--model-path", GOLDEN, "--device", "cpu",
                       "--nsamples", "2", "--seqlen", "16"] + argv)
