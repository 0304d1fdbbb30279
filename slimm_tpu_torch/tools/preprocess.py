# Copied from slimm_tpu/tools/preprocess.py (the port imports nothing of
# slimm_tpu); run it as `python -m slimm_tpu_torch.tools.preprocess`.
"""Reference-database preparation tooling (Python 3).

Re-implements the behavior of the reference's `preprocessing/` scripts
(reference download_refs.py, merge_files.py, update_refs.py,
helper_methods.py — Python 2) as an importable, unit-testable module:

  * assembly-summary genome selection, one genome per taxon, priority
    reference genome > representative genome > Complete Genome >
    Chromosome > (Scaffold > Contig only when the assembly's taxid matches
    or it is the sole candidate) — download_refs.py:150-191
  * taxonomy reduction to the clades of interest via parent-chain walks —
    download_refs.py:203-245
  * per-taxon genome merge into one FASTA with `acc|kraken:taxid|<taxid>`
    headers, subsequent contigs joined by a line of N's, plasmids skipped —
    merge_files.py:44-74 (this header convention is what
    database.get_accession_id parses)
  * incremental refresh with `.old/` snapshot + rollback on exception —
    update_refs.py:381-396

Deviations from the reference (intentional, documented):
  * reduced names.dmp / nodes.dmp are written in the ORIGINAL dmp column
    format (`\t|\t` separators).  The reference writes plain TSV
    (download_refs.py:241-244) which its own slimm_build nodes parser
    (slimm_build.cpp:295-308) cannot actually read back — the `>> int` +
    getline-'\t' skip dance only lines up with the `\t|\t` layout.
  * downloads use urllib.request + ThreadPoolExecutor over HTTPS.

Network operations are isolated behind `fetch()` so everything else is
testable offline.
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import sys
import tarfile
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from datetime import datetime

NCBI_TAXONOMY = "https://ftp.ncbi.nih.gov/pub/taxonomy/"
ASSEMBLY_SUMMARY = {
    "refseq": "https://ftp.ncbi.nlm.nih.gov/genomes/refseq/"
              "assembly_summary_refseq.txt",
    "genbank": "https://ftp.ncbi.nlm.nih.gov/genomes/ASSEMBLY_REPORTS/"
               "assembly_summary_genbank.txt",
}

ASSEMBLY_LEVELS = ("Complete Genome", "Chromosome", "Scaffold", "Contig")


def fetch(url: str, destination: str) -> str:
    """Download url → destination (the single network touch point)."""
    urllib.request.urlretrieve(url, destination)
    return destination


def extract_then_delete(source: str, destination: str) -> None:
    """Extract a .tar[.gz] archive and remove it (helper_methods.py:16-25)."""
    mode = "r:gz" if source.endswith("tar.gz") else "r:"
    with tarfile.open(source, mode) as tar:
        tar.extractall(path=destination)
    os.remove(source)


# ---------------------------------------------------------------------------
# genome selection (download_refs.py:104-191)
# ---------------------------------------------------------------------------


@dataclass
class AssemblyCandidate:
    """One assembly_summary row for a taxon."""

    level: str            # assembly_level (col 11)
    date: str             # seq_rel_date (col 13)
    url: str              # <ftp_path>/<basename>_genomic.fna.gz
    taxid_str: str        # taxid column as text (col 6)
    category: str         # refseq_category (col 4)


def parse_categories(lines, groups: str, subset_taxids=()) -> dict:
    """categories.dmp rows → {taxid: 1} for the letter groups of interest
    (A=Archaea, B=Bacteria, V=Viruses/Viroids) plus explicit taxids
    (download_refs.py:115-122).  Both the species-level (col 2) and the
    assembly-level (col 3) taxid are included."""
    initial = {}
    subset = set(int(t) for t in subset_taxids)
    for line in lines:
        cols = line.split("\t")
        if len(cols) < 3:
            continue
        if cols[0] in groups or int(cols[1]) in subset or int(cols[2]) in subset:
            initial[int(cols[1])] = 1
            initial[int(cols[2])] = 1
    return initial


def parse_assembly_summary(lines, initial_taxids: dict,
                           species_level: bool = False) -> dict:
    """assembly_summary rows → {taxid: [AssemblyCandidate, ...]}
    (download_refs.py:104-142).  Only `latest` assemblies with a real
    ftp path and a recognized category/level are kept."""
    taxid_col = 6 if species_level else 5
    out: dict[int, list[AssemblyCandidate]] = {}
    keywords = ("representative genome", "reference genome") + ASSEMBLY_LEVELS
    for line in lines:
        if line.startswith("#"):
            continue
        if not any(k in line for k in keywords):
            continue
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 20:
            continue
        taxid = int(cols[taxid_col])
        path = cols[19]
        if taxid not in initial_taxids or path == "na" or cols[10] != "latest":
            continue
        url = path + path[path.rfind("/"):] + "_genomic.fna.gz"
        out.setdefault(taxid, []).append(AssemblyCandidate(
            level=cols[11], date=cols[13], url=url, taxid_str=cols[6],
            category=cols[4]))
    return out


def select_genome(taxid: int, candidates: list) -> AssemblyCandidate | None:
    """One genome per taxon, reference priority order
    (download_refs.py:150-186): reference genome > representative genome >
    Complete Genome > Chromosome; Scaffold/Contig only when the LAST
    candidate's own taxid equals the taxon or there is a single candidate
    (replicating the reference's use of the loop-leaked `options`
    variable)."""
    if not candidates:
        return None
    for cat in ("reference genome", "representative genome"):
        for c in candidates:
            if c.category == cat:
                return c
    for lvl in ("Complete Genome", "Chromosome"):
        for c in candidates:
            if c.level == lvl:
                return c
    last = candidates[-1]  # the leaked loop variable (download_refs.py:176)
    if str(taxid) == last.taxid_str or len(candidates) == 1:
        for lvl in ("Scaffold", "Contig"):
            for c in candidates:
                if c.level == lvl:
                    return c
    return None


# ---------------------------------------------------------------------------
# taxonomy reduction (download_refs.py:203-245)
# ---------------------------------------------------------------------------


def load_taxonomy_dmp(nodes_lines, names_lines):
    """Parse nodes.dmp / names.dmp (scientific names only)."""
    parent, rank, names = {}, {}, {}
    for line in names_lines:
        if "scientific name" in line:
            cols = line.split("\t|\t")
            names[int(cols[0])] = cols[1].split("\t|")[0]
    for line in nodes_lines:
        cols = line.split("\t|\t")
        taxid = int(cols[0])
        parent[taxid] = int(cols[1])
        # last-column lines carry the trailing "\t|" terminator
        rank[taxid] = cols[2].split("\t|")[0].rstrip("\n")
    return parent, rank, names


def reduce_taxonomy(initial_taxids, parent, rank, names):
    """Parent-chain walk from every taxon of interest to the root; returns
    ({taxid: 1} of every node on those paths) — download_refs.py:224-235."""
    keep = {}
    for taxid in initial_taxids:
        current = taxid
        while current != 1:
            if current not in parent:
                print(f"{current} is not in the node file. may be, it is in "
                      "deleted nodes!", file=sys.stderr)
                break
            keep[current] = 1
            current = parent[current]
    return keep


def write_reduced_dmp(keep, parent, rank, names, nodes_out: str,
                      names_out: str) -> None:
    """Write the reduced taxonomy in dmp column format (`\t|\t`), readable
    by both this package's DB builder and the reference's slimm_build."""
    with open(nodes_out, "w") as nf, open(names_out, "w") as mf:
        for taxid in keep:
            nf.write(f"{taxid}\t|\t{parent[taxid]}\t|\t{rank[taxid]}\t|\n")
            mf.write(f"{taxid}\t|\t{names.get(taxid, '')}\t|\t\t|\t"
                     "scientific name\t|\n")


# ---------------------------------------------------------------------------
# genome merge (merge_files.py:44-74)
# ---------------------------------------------------------------------------


def merge_genome_file(fasta_gz_path: str, taxon: str, out) -> tuple[int, int]:
    """Append one per-taxon genome to the combined FASTA.

    First contig header becomes `<acc>|kraken:taxid|<taxon> <desc>`; every
    later contig is joined with a line of N's (one input line long) instead
    of a new header; contigs whose header contains 'plasmid' are skipped
    entirely.  Returns (contigs_written, plasmids_skipped)."""
    count = 0
    plasmids = 0
    line_len = 0
    is_plasmid = False
    opener = gzip.open if fasta_gz_path.endswith(".gz") else open
    with opener(fasta_gz_path, "rt") as f:
        for line in f:
            if line.startswith(">"):
                is_plasmid = "plasmid" in line.lower()
                if is_plasmid:
                    plasmids += 1
                    continue
                if count == 0:
                    parts = line.split()
                    out.write(parts[0] + "|kraken:taxid|" + taxon
                              + " " + " ".join(parts[1:]) + "\n")
                else:
                    out.write(line_len * "N" + "\n")
                count += 1
            elif not is_plasmid:
                out.write(line)
                if line_len == 0:
                    line_len = len(line) - 1
    return count, plasmids


def merge_genomes(genomes_dir: str, out_path: str,
                  extension: str = ".fna.gz") -> int:
    """Merge every <taxid>.fna.gz in genomes_dir into one combined FASTA."""
    files = sorted(f for f in os.listdir(genomes_dir)
                   if f.endswith(extension))
    total = 0
    with open(out_path, "w") as out:
        for fname in files:
            taxon = fname[:-len(extension)]
            count, plasmids = merge_genome_file(
                os.path.join(genomes_dir, fname), taxon, out)
            total += count
            print(f"{fname} .\t {count} seqs\t{plasmids} plasmids\tall seqs "
                  "written delimited by a line of N's. all plasmids are "
                  "ignored", file=sys.stderr)
    return total


# ---------------------------------------------------------------------------
# download orchestration (download_refs.py main flow)
# ---------------------------------------------------------------------------


@dataclass
class DownloadPlan:
    """Everything decided before any genome bytes move."""

    selections: dict = field(default_factory=dict)   # taxid → AssemblyCandidate
    keep_taxids: dict = field(default_factory=dict)  # reduced taxonomy nodes
    parent: dict = field(default_factory=dict)
    rank: dict = field(default_factory=dict)
    names: dict = field(default_factory=dict)


def build_plan(categories_lines, assembly_lines, nodes_lines, names_lines,
               groups: str = "AB", subset_taxids=(),
               species_level: bool = False) -> DownloadPlan:
    """Pure planning stage: pick one genome per taxon + reduce taxonomy."""
    initial = parse_categories(categories_lines, groups, subset_taxids)
    by_taxid = parse_assembly_summary(assembly_lines, initial, species_level)
    selections = {}
    for taxid, cands in by_taxid.items():
        sel = select_genome(taxid, cands)
        if sel is not None:
            selections[taxid] = sel
    parent, rank, names = load_taxonomy_dmp(nodes_lines, names_lines)
    keep = reduce_taxonomy(initial, parent, rank, names)
    return DownloadPlan(selections=selections, keep_taxids=keep,
                        parent=parent, rank=rank, names=names)


def download_refs(workdir: str, groups: str = "AB", subset_taxids=(),
                  species_level: bool = False, database: str = "refseq",
                  threads: int = 4, testing: bool = False) -> str:
    """Full download workflow; returns the genomes directory."""
    os.makedirs(workdir, exist_ok=True)
    if os.listdir(workdir):
        raise SystemExit(f"[ERROR!] Working directory [{workdir}] should be "
                         "empty!")
    today = datetime.now().strftime("%d%m%Y")
    genomes_dir = os.path.join(workdir, f"genomes_{today}")
    slimmdb_dir = os.path.join(workdir, f"slimmDB_{today}")
    os.makedirs(genomes_dir)
    os.makedirs(slimmdb_dir)

    taxdmp = _taxonomy_download("taxdump", workdir, today)
    taxcat = _taxonomy_download("taxcat", workdir, today)
    summary_path = os.path.join(
        workdir, f"assembly_summary_{database}_{today}.txt")
    print("Downloading assembly_summary file ...", file=sys.stderr)
    fetch(ASSEMBLY_SUMMARY[database], summary_path)

    with open(os.path.join(taxcat, "categories.dmp")) as f:
        cat_lines = f.readlines()
    with open(summary_path) as f:
        sum_lines = f.readlines()
    with open(os.path.join(taxdmp, "nodes.dmp")) as f:
        nodes_lines = f.readlines()
    with open(os.path.join(taxdmp, "names.dmp")) as f:
        names_lines = f.readlines()
    plan = build_plan(cat_lines, sum_lines, nodes_lines, names_lines,
                      groups, subset_taxids, species_level)

    groups_name = groups or "CUSTOM"
    if subset_taxids:
        groups_name += "_CUSTOM"
    todl_path = os.path.join(workdir, f"{groups_name}_genomes_to_download.txt")
    with open(todl_path, "w") as f:
        for taxid, sel in plan.selections.items():
            f.write(f"{taxid}\t{sel.taxid_str}\t{sel.level}\t{sel.date}\t"
                    f"{sel.url}\n")
    write_reduced_dmp(plan.keep_taxids, plan.parent, plan.rank, plan.names,
                      os.path.join(slimmdb_dir, "nodes.dmp"),
                      os.path.join(slimmdb_dir, "names.dmp"))

    items = list(plan.selections.items())
    if testing:
        items = items[:50]
    print(f"Downloading {len(items)} reference genomes. This might take a "
          "while! ...", file=sys.stderr)
    lock = threading.Lock()
    done = [0]

    def one(item):
        taxid, sel = item
        dest = os.path.join(genomes_dir, f"{taxid}.fna.gz")
        try:
            fetch(sel.url, dest)
        except Exception as e:  # keep going; report at the end
            return (taxid, str(e))
        with lock:
            done[0] += 1
            print(f"\r{len(items) - done[0]} of {len(items)} remaining ...",
                  end="", file=sys.stderr)
        return None

    with ThreadPoolExecutor(max_workers=threads) as ex:
        failures = [r for r in ex.map(one, items) if r is not None]
    print(file=sys.stderr)
    for taxid, err in failures:
        print(f"[WARNING] download failed for taxid {taxid}: {err}",
              file=sys.stderr)
    return genomes_dir


def _taxonomy_download(taxa_type: str, workdir: str, today: str) -> str:
    """taxdump/taxcat tarball → extracted folder (helper_methods.py:62-73)."""
    folder = os.path.join(workdir, f"{taxa_type}_{today}")
    tarball = folder + ".tar.gz"
    print(f"Downloading {taxa_type} file ...", file=sys.stderr)
    fetch(NCBI_TAXONOMY + taxa_type + ".tar.gz", tarball)
    extract_then_delete(tarball, folder)
    return folder


# ---------------------------------------------------------------------------
# incremental update (update_refs.py:381-396 snapshot/rollback shape)
# ---------------------------------------------------------------------------


def update_refs(workdir: str, **kwargs) -> str:
    """Refresh an existing working directory: snapshot everything into
    `.old/`, re-run the download workflow, roll the snapshot back on any
    exception (update_refs.py:102-107, 381-396)."""
    old_dir = os.path.join(workdir, ".old")
    if os.path.isdir(old_dir):
        shutil.rmtree(old_dir)
    os.makedirs(old_dir)
    for entry in list(os.listdir(workdir)):
        if entry == ".old":
            continue
        shutil.move(os.path.join(workdir, entry), os.path.join(old_dir, entry))
    try:
        return download_refs(workdir, **kwargs)
    except BaseException:
        for entry in list(os.listdir(workdir)):
            if entry == ".old":
                continue
            path = os.path.join(workdir, entry)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        for entry in list(os.listdir(old_dir)):
            shutil.move(os.path.join(old_dir, entry),
                        os.path.join(workdir, entry))
        os.rmdir(old_dir)
        raise


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="slimm_tpu_torch.tools.preprocess",
        description="Reference-database preparation (download / merge / "
                    "update)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("download", help="download reference genomes")
    d.add_argument("-wd", "--workdir", required=True)
    d.add_argument("-g", "--groups", default="AB")
    d.add_argument("-s", "--sp", dest="species_level", action="store_true")
    d.add_argument("-t", "--taxa_ids", default="")
    d.add_argument("-tr", "--threads", type=int, default=4,
                   choices=range(1, 11))
    d.add_argument("-d", "--database", choices=["refseq", "genbank"],
                   default="refseq")
    d.add_argument("-ts", "--testing", action="store_true")

    m = sub.add_parser("merge", help="merge per-taxon genomes into one FASTA")
    m.add_argument("workdir")

    u = sub.add_parser("update", help="incremental refresh with rollback")
    u.add_argument("-wd", "--workdir", required=True)
    u.add_argument("-g", "--groups", default="AB")
    u.add_argument("-s", "--sp", dest="species_level", action="store_true")
    u.add_argument("-t", "--taxa_ids", default="")
    u.add_argument("-tr", "--threads", type=int, default=4)
    u.add_argument("-d", "--database", choices=["refseq", "genbank"],
                   default="refseq")

    args = p.parse_args(argv)
    if args.cmd == "download":
        subset = [int(t) for t in args.taxa_ids.split(",") if t]
        download_refs(args.workdir, args.groups, subset, args.species_level,
                      args.database, args.threads, args.testing)
    elif args.cmd == "merge":
        # mirror merge_files.py's directory discovery
        genomes_dir = groups = db_choice = ""
        for entry in os.listdir(args.workdir):
            if "genomes" in entry and "genomes_to_download" not in entry:
                genomes_dir = entry
            elif "genomes_to_download" in entry:
                groups = entry.replace("_genomes_to_download", "").replace(
                    ".txt", "")
            elif "assembly_summary_" in entry:
                db_choice = entry.replace("assembly_summary_", "").replace(
                    ".txt", "")
        out = os.path.join(args.workdir, f"{groups}_{db_choice}_combined.fna")
        merge_genomes(os.path.join(args.workdir, genomes_dir), out)
        print(f"merged file written to {out}", file=sys.stderr)
    elif args.cmd == "update":
        subset = [int(t) for t in args.taxa_ids.split(",") if t]
        update_refs(args.workdir, groups=args.groups, subset_taxids=subset,
                    species_level=args.species_level, database=args.database,
                    threads=args.threads)


if __name__ == "__main__":
    main()
