"""End-to-end example on the PyTorch port: serve small LMs with batched
requests through the port's inference engine (continuous batching + KV cache
+ logprob scoring) and run the semantic-operator pipeline of
``serve_semantic_pipeline.py`` on top of it, with randomly initialized
weights.  It imports only ``repro_torch`` and runs on the card unless asked
for the CPU.

    PYTHONPATH=src python examples/serve_semantic_pipeline_torch.py [--device cpu]
"""
import argparse
import time

import repro_torch
from repro_torch.core.backends.torch_engine import make_session
from repro_torch.core.frame import SemFrame

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
args = ap.parse_args()
if args.device:
    repro_torch.set_device(args.device)

print(f"building oracle/proxy engines + embedding encoder (PyTorch, "
      f"{repro_torch.current_device()})...")
sess = make_session(max_seq=256)

records = [{"claim": f"statement {i}: widget-{i % 7} is compatible with gadget-{i % 3}"}
           for i in range(24)]
sf = SemFrame(records, sess)

t0 = time.time()
mapped = sf.sem_map("rewrite {claim} as a question")
print(f"sem_map over engine: {len(mapped)} generations in {time.time()-t0:.1f}s "
      f"({mapped.last_stats()['generate_calls']} LM calls, continuous batching)")

t0 = time.time()
filtered = sf.sem_filter("the {claim} is plausible",
                         recall_target=0.8, precision_target=0.8, delta=0.3)
st = sf.last_stats()
print(f"sem_filter cascade: {len(filtered)} pass in {time.time()-t0:.1f}s "
      f"(proxy scored {st['proxy_calls']}, oracle confirmed {st['oracle_calls']})")

idx = sf.sem_index("claim")
hits = sf.sem_search("claim", "widget-3 compatibility", k=3, index=idx)
print("sem_search top-3:", [t["claim"][:40] for t in hits.records])
print("engine stats:", sess.oracle._m.engine.stats)
