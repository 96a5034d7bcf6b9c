import sys, time, importlib.util, types
sys.path.insert(0, "/root/repo"); sys.path.insert(0, "/root/repo/tests"); sys.path.insert(0, "scripts_dev")
import os
import jax; jax.config.update("jax_platforms","cpu")
sys.argv=["x"]
import defuse_tpu.align.frontend as F
# wrap stages with timers
orig_align_all = F._align_all
orig_bpp = F._best_proper_pairs
acc = {}
def timed(name, fn):
    def w(*a, **k):
        t0=time.time(); r = fn(*a,**k); acc[name] = acc.get(name,0)+time.time()-t0; return r
    return w
F._align_all = timed("align_all", orig_align_all)
F._best_proper_pairs = timed("best_proper_pairs", orig_bpp)
spec = importlib.util.spec_from_file_location("scale_demo", "scripts_dev/scale_demo.py")
m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)
t0=time.time()
m.main(n_background=200000, use_device=False)
print("stage totals:", {k: round(v,1) for k,v in acc.items()})
