"""hist_roofline_pct.core: the share of the HBM roofline that the
profile's histogram kernels reach in the traced window, in percent.

The least time is the bytes these inputs' histogram work must move at the
H100 SXM's 3.35 TB/s (NVIDIA's data sheet, at its 700 W limit), each byte
read once and written once: pass A's two counts over the bin domain
(an int32 index and two one-byte weights per record, two int32 bins per
bin), pass B's count over [contigs | dense taxa] and its pair presence over
the padded (contig x code) slots (an int32 index and a one-byte weight per
record, one int32 per bin).  The same arithmetic as the kernel table of
PERF.md, copied here so that the program's changes leave it as it is; the
sizes are the reference's (reference/slimm.py `work`), never the program's
launch arguments.  The time is the torch.profiler device time of the
kernels named below (csrc/hist.cu, launched by slimm_hist2 / slimm_hist1).
A kernel renamed or fused away leaves this metric silent (None).
"""

HBM_BYTES_PER_S = 3.35e12
KERNELS = ("hist2_global", "hist2_shared", "split_packed", "hist1_global",
           "hist1_shared")


def hist_bytes(records, bins, contigs, dense_taxa, pair_codes) -> int:
    """Bytes of one profile's histogram work (emit_coverage off)."""
    pair_slots = -(-contigs * pair_codes // 1024) * 1024
    pass_a = records * (4 + 2) + 2 * bins * 4
    pass_b = records * (4 + 1) + (contigs + dense_taxa) * 4
    pairs = records * (4 + 1) + pair_slots * 4
    return pass_a + pass_b + pairs


def _ours(name: str) -> bool:
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip().split(" ")[-1] in KERNELS


def read(run):
    t = run.trace
    if run.traffic["entry"] != "arrays" or t is None or not run.work:
        return None
    kernel_s = t.device_time_s(_ours)
    if kernel_s <= 0:
        return None
    total = sum(hist_bytes(**run.work[c.sample]) for c in run.calls)
    return 100.0 * total / HBM_BYTES_PER_S / kernel_s
