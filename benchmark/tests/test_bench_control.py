"""The control on the card: the reference in the program's place,
computed with TF32 on (the precision just below the configurations'
fp32 with TF32 off), fails the check of every cell at a small size."""
import json

import pytest

from benchmark import harness, head


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["train.b32", "infer.b64", "pretrain.b32"])
def test_control_is_not_correct(card, cell_name):
    cell = harness.find(cell_name)
    cfg = json.loads(json.dumps(cell.cfg))
    cfg["image_size"] = 112
    cfg["train"]["batch_size"] = 8
    traffic = dict(cell.traffic, batch=8, pool=3)
    ctx = harness.Context(cfg, traffic, cell.spec, 2 ** 31 + 3, card, head.head(full_size=True),
                          control=True)
    e = harness.entry(cell, ctx)
    e.setup()
    if traffic["entry"] != "train_step":
        for _ in range(4):
            e.call()
    e.release()
    checked = e.check()
    checks = harness.numbers_line(checked["numbers"], cell.limits, checked["coverage"])
    assert not harness.verdict(checks), checks
