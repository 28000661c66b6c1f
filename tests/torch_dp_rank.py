"""One rank of a width-W dp trial of the port on the CPU, over gloo.

    python tests/torch_dp_rank.py RANK WORLD PORT TEMPLATE KNOBS_JSON BLOB TRAIN VAL OUT

``tests/test_torch_dp.py`` starts W of these (imported as a module, it
also gives that test the templates and the dropout spy). Each rank joins
a gloo group at ``127.0.0.1:PORT``, loads the float32 start params of
``BLOB`` into a ``TEMPLATE`` trial (``ff`` or ``vgg``) with its dp mesh
set, trains it on ``TRAIN``, scores it on ``VAL`` and pickles to ``OUT``
what the test compares: the logged epoch metrics, the health dicts, the
score, the final params, its rows of the first global batch and the
first dropout mask it drew. Imports torch and the port only.
"""

import json
import pickle
import sys

import torch

from rafiki_tpu_torch.convert import state_dict_to_flax
from rafiki_tpu_torch.model.log import logger
from rafiki_tpu_torch.models import vgg as vgg_module
from rafiki_tpu_torch.models.ff import FeedForward, _Mlp
from rafiki_tpu_torch.models.vgg import Vgg, _Vgg
from rafiki_tpu_torch.ops import train as ops_train
from rafiki_tpu_torch.parallel import multihost


class FF32(FeedForward):
    def build_module(self, num_classes, input_shape):
        return _Mlp(self.knobs["hidden_layers"], self.knobs["hidden_units"], num_classes,
                    input_shape, dtype=torch.float32)


class Vgg32(Vgg):
    def build_module(self, num_classes, input_shape):
        return _Vgg(self.knobs["depth"], self.knobs["width_mult"], num_classes, input_shape,
                    dtype=torch.float32, dropout=self.knobs["dropout"])


TEMPLATES = {"ff": FF32, "vgg": Vgg32}


def spy(record):
    """Wrap the port's dropout and its dp batch placement to record, into
    ``record``, the first keep-mask drawn (from a twin of the generator,
    so the trial's stream is untouched) and the first batch slice put.
    Returns the undo."""
    drop, put = vgg_module._dropout, multihost.global_put

    def dropout(x, rate, generator, deterministic):
        if generator is not None and not deterministic and "mask" not in record:
            dp = isinstance(generator, ops_train.DpGenerator)
            g = generator.generator if dp else generator
            twin = torch.Generator(device=g.device)
            twin.set_state(g.get_state())
            if dp:
                twin = ops_train.DpGenerator(twin, generator.rank, generator.world_size)
            record["mask"] = (drop(torch.ones_like(x), rate, twin, False) != 0).numpy()
        return drop(x, rate, generator, deterministic)

    def global_put(batch, mesh):
        out = put(batch, mesh)
        record.setdefault("rows", {k: v.numpy().copy() for k, v in out.items()})
        return out

    vgg_module._dropout = dropout
    multihost.global_put = global_put

    def undo():
        vgg_module._dropout, multihost.global_put = drop, put

    return undo


def train(template, knobs, blob, train_uri, val_uri, mesh=None):
    """One trial from ``blob``'s params: load -> train -> evaluate, as
    ``tests/test_torch_train.py train_one`` runs it, on a dp mesh when
    given. Returns what the test compares."""
    record = {}
    undo = spy(record)
    try:
        return _train(record, template, knobs, blob, train_uri, val_uri, mesh)
    finally:
        undo()


def _train(record, template, knobs, blob, train_uri, val_uri, mesh):
    m = TEMPLATES[template](device="cpu", **knobs)
    if mesh is not None:
        m.set_mesh(mesh)
    n_train = int(train_uri.split("n=")[1].split("&")[0])
    m._planned_steps = knobs["epochs"] * (n_train // knobs["batch_size"])
    m.load_parameters(blob)
    health = []
    check = m._loop._health_check

    def health_spy(out, *args, **kwargs):
        health.append({k: v for k, v in out.items() if k.startswith("health_")})
        return check(out, *args, **kwargs)

    m._loop._health_check = health_spy
    logs = []
    with logger.capture(logs.append):
        m.train(train_uri)
    score = m.evaluate(val_uri)
    params = {k: v.numpy() for k, v in state_dict_to_flax(m._module).items()}
    return {"values": [e["values"] for e in logs if e["type"] == "values"], "health": health,
            "score": score, "params": params, "rows": record.get("rows"),
            "mask": record.get("mask")}


def main(rank, world, port, template, knobs, blob_path, train_uri, val_uri, out) -> int:
    import datetime

    import torch.distributed as dist

    from rafiki_tpu_torch.parallel.mesh import data_parallel_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    with open(blob_path, "rb") as f:
        blob = f.read()
    result = train(template, json.loads(knobs), blob, train_uri, val_uri,
                   data_parallel_mesh([torch.device("cpu")]))
    with open(out, "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(main(int(a[0]), int(a[1]), int(a[2]), a[3], a[4], a[5], a[6], a[7], a[8]))
