"""Supervised baseline, ``algorithm: base`` (counterpart of
``semi_seg_ecg_tpu/algorithms/base.py``): cross-entropy on the labeled
batch plus the weighted auxiliary-head losses. The loop, schedule, NaN
abort and checkpoints are shared (``common.py``).
"""

from __future__ import annotations

from .common import AlgorithmSpec, run_test, run_training


def aux_loss_weights(train_cfg, n):
    # the reference writes 'auxiliary_loss_weight' in configs but reads
    # 'auxiliary_loss_weights' in code (base.py:126-128 vs scratch.yaml:87);
    # accept both
    ws = train_cfg.get("auxiliary_loss_weights",
                       train_cfg.get("auxiliary_loss_weight", [0.4]))
    return list(ws)[:n] if n else []


def make_train_step(model, optimizer, config, amp):
    train_cfg = config["train"]

    def train_step(batch):
        model.train()
        with amp():
            out = model(batch["ecg"], labels=batch["target"],
                        return_loss=True)
            loss = out["loss"]
            if "loss_aux" in out:
                for w, aux in zip(aux_loss_weights(train_cfg,
                                                   len(out["loss_aux"])),
                                  out["loss_aux"]):
                    loss = loss + w * aux
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return train_step


SPEC = AlgorithmSpec(name="base", make_train_step=make_train_step)


def train(config):
    run_training(config, SPEC)


def test(config):
    return run_test(config)
