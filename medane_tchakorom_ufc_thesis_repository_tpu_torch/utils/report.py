"""HTML report generation from bulk-run JSONL logs (a copy of the JAX
package's ``utils/report.py``: its output strings are byte-equal).

Parity with the reference's XSLT pipeline (``performance_xml2html.xsl``
rendering PETSc ``-log_view ::ascii_xml`` output, SURVEY.md §2.6): turn
machine-readable run records into a browsable table.

Usage::

    python -m medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.report \
        bulk_runs.jsonl -o report.html
"""

from __future__ import annotations

import argparse
import html
import json
import sys
from typing import Dict, List

_COLUMNS = [
    ("alg", "algorithm"),
    ("backend", "backend"),
    ("grid", "grid"),
    ("rtol", "rtol"),
    ("converged", "conv"),
    ("sweeps", "sweeps"),
    ("cycles", "cycles"),
    ("inner_iters", "inner it"),
    ("elapsed_s", "solve s"),
    ("wall_s", "wall s"),
    ("rel_rnorm", "rel ‖r‖"),
    ("error_vs_ones", "err vs u=1"),
    ("error", "error"),
]


def render(records: List[Dict], title: str = "bulk run report") -> str:
    cols = [(k, label) for k, label in _COLUMNS
            if any(k in r for r in records)]
    rows = []
    for r in records:
        tds = []
        for k, _ in cols:
            v = r.get(k, "")
            if isinstance(v, float):
                v = f"{v:.3g}"
            tds.append(f"<td>{html.escape(str(v))}</td>")
        cls = "ok" if r.get("converged") else "bad"
        rows.append(f'<tr class="{cls}">{"".join(tds)}</tr>')
    head = "".join(f"<th>{html.escape(label)}</th>" for _, label in cols)
    return f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>
body {{ font: 14px system-ui, sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }}
th, td {{ border: 1px solid #ccc; padding: 4px 10px; text-align: right; }}
th {{ background: #f0f0f0; }}
tr.ok td:first-child {{ border-left: 4px solid #3a6; }}
tr.bad td:first-child {{ border-left: 4px solid #c33; }}
</style></head><body>
<h1>{html.escape(title)}</h1>
<p>{len(records)} runs, {sum(1 for r in records if r.get("converged"))} converged.</p>
<table><thead><tr>{head}</tr></thead><tbody>
{chr(10).join(rows)}
</tbody></table></body></html>
"""


# Flamegraph stage colors: the validated default categorical order
# (dataviz reference palette, fixed assignment by first appearance —
# never cycled).  Bars are light tints with a solid hue keel so labels
# stay in ink tokens; (light, dark) per slot.
_FLAME_SERIES = [
    ("#2a78d6", "#3987e5"),   # blue
    ("#eb6834", "#d95926"),   # orange
    ("#1baf7a", "#199e70"),   # aqua
    ("#eda100", "#c98500"),   # yellow
    ("#e87ba4", "#d55181"),   # magenta
    ("#008300", "#008300"),   # green
    ("#4a3aa7", "#9085e9"),   # violet
    ("#e34948", "#e66767"),   # red
]


def folded(items) -> str:
    """PhaseTimer items -> folded-stack lines (``stage;sub value_us``),
    the format ``-log_view ::ascii_flamegraph`` emits and external
    flamegraph tools (speedscope, flamegraph.pl) ingest.  Nested stages
    use '/' in the phase name."""
    out = []
    for name, secs, _calls in items:
        out.append(f"{name.replace('/', ';')} {int(secs * 1e6)}")
    return "\n".join(out) + "\n"


def render_flamegraph(items, title: str = "stage timers") -> str:
    """PhaseTimer items -> self-contained flamegraph-style HTML (the
    ``performance_xml2html.xsl`` / ``-log_view ::ascii_flamegraph``
    analog): one row per nesting level, bar width proportional to wall
    time, plus the exact numbers as a table."""
    # aggregate into a tree on '/'-separated stage paths
    tree: Dict = {}
    for name, secs, calls in items:
        node, path = tree, name.split("/")
        for seg in path:
            node = node.setdefault(seg, {"_t": 0.0, "_c": 0, "_kids": {}})
            node["_t"] += secs
            node["_c"] += calls
            node = node["_kids"]
    total = sum(v["_t"] for v in tree.values()) or 1.0

    slot_of: Dict[str, int] = {}

    def slot(seg: str) -> int:
        if seg not in slot_of:
            slot_of[seg] = len(slot_of) % len(_FLAME_SERIES)
        return slot_of[seg]

    rows: List[List[str]] = []

    def emit(level: Dict, depth: int, offset: float):
        while len(rows) <= depth:
            rows.append([])
        off = offset
        for seg, v in level.items():
            w = 100.0 * v["_t"] / total
            s = slot(seg)
            tip = (f"{seg}: {v['_t']:.4f} s, {v['_c']} calls, "
                   f"{100.0 * v['_t'] / total:.1f}%")
            rows[depth].append(
                f'<div class="f s{s}" style="left:{off:.3f}%;'
                f'width:{max(w - 0.15, 0.05):.3f}%" title="{html.escape(tip)}">'
                f'<span>{html.escape(seg)} {v["_t"]:.3f}s</span></div>'
            )
            emit(v["_kids"], depth + 1, off)
            off += w

    emit(tree, 0, 0.0)
    lanes = "\n".join(
        f'<div class="lane">{"".join(r)}</div>' for r in rows if r
    )
    series_css = "\n".join(
        f".s{i} {{ background: {light}26; border-left: 3px solid {light}; }}\n"
        f"@media (prefers-color-scheme: dark) {{ "
        f".s{i} {{ background: {dark}33; border-left-color: {dark}; }} }}"
        for i, (light, dark) in enumerate(_FLAME_SERIES)
    )
    trs = "\n".join(
        f"<tr><td>{html.escape(name)}</td><td>{secs:.4f}</td>"
        f"<td>{calls}</td><td>{100.0 * secs / total:.1f}%</td></tr>"
        for name, secs, calls in items
    )
    return f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>
:root {{ --surface: #fcfcfb; --ink: #0b0b0b; --ink2: #52514e; }}
@media (prefers-color-scheme: dark) {{
  :root {{ --surface: #1a1a19; --ink: #ffffff; --ink2: #c3c2b7; }}
}}
body {{ font: 14px system-ui, sans-serif; margin: 2em;
       background: var(--surface); color: var(--ink); }}
.lane {{ position: relative; height: 28px; margin-bottom: 2px; }}
.f {{ position: absolute; top: 0; height: 26px; border-radius: 4px;
     overflow: hidden; white-space: nowrap; box-sizing: border-box; }}
.f span {{ font-size: 12px; color: var(--ink); padding: 5px 4px;
          display: inline-block; }}
{series_css}
table {{ border-collapse: collapse; margin-top: 1.5em; }}
th, td {{ border: 1px solid var(--ink2); padding: 4px 10px;
         text-align: right; }}
th {{ text-align: left; }}
caption, h1 {{ text-align: left; }}
</style></head><body>
<h1>{html.escape(title)}</h1>
<p style="color: var(--ink2)">total {total:.4f} s — widths are share of
total wall time (PetscLog-stage analog; hover for exact numbers)</p>
{lanes}
<table><thead><tr><th>stage</th><th>time s</th><th>calls</th>
<th>share</th></tr></thead><tbody>
{trs}
</tbody></table></body></html>
"""


def render_xml(items, title: str = "stage timers") -> str:
    """PhaseTimer items -> nested-timer XML, the ``-log_view
    ::ascii_xml`` analog (the report the reference renders with
    ``performance_xml2html.xsl``): a ``<root>`` with recursively nested
    ``<event>`` entries carrying name / time / ncalls / percent of
    total.  '/'-separated phase names nest.  Pairs with
    ``render_xml_stylesheet`` — write it next to the XML and the
    ``<?xml-stylesheet?>`` header renders the report in a browser."""
    tree: Dict = {}
    for name, secs, calls in items:
        node = tree
        for seg in name.split("/"):
            node = node.setdefault(seg, {"_t": 0.0, "_c": 0, "_kids": {}})
            node["_t"] += secs
            node["_c"] += calls
            node = node["_kids"]
    total = sum(v["_t"] for v in tree.values()) or 1.0

    def emit(level: Dict, depth: int) -> List[str]:
        pad = "  " * depth
        out = []
        for seg, v in level.items():
            out.append(
                f"{pad}<event>\n"
                f"{pad}  <name>{html.escape(seg)}</name>\n"
                f"{pad}  <time>{v['_t']:.6f}</time>\n"
                f"{pad}  <ncalls>{v['_c']}</ncalls>\n"
                f"{pad}  <percent>{100.0 * v['_t'] / total:.2f}</percent>"
            )
            kids = emit(v["_kids"], depth + 2)
            if kids:
                out.append(f"{pad}  <events>")
                out.extend(kids)
                out.append(f"{pad}  </events>")
            out.append(f"{pad}</event>")
        return out

    body = "\n".join(emit(tree, 1))
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<?xml-stylesheet type="text/xsl" href="performance_xml2html.xsl"?>\n'
        f"<root>\n  <title>{html.escape(title)}</title>\n"
        f"  <totaltime>{total:.6f}</totaltime>\n"
        f"{body}\n</root>\n"
    )


def render_xml_stylesheet() -> str:
    """Companion XSLT turning ``render_xml`` output into an HTML table
    (our own small analog of the reference's third-party
    ``performance_xml2html.xsl`` — written from scratch for this
    format, not copied)."""
    return """<?xml version="1.0" encoding="UTF-8"?>
<xsl:stylesheet version="1.0"
    xmlns:xsl="http://www.w3.org/1999/XSL/Transform">
<xsl:template match="/root">
<html><head><title><xsl:value-of select="title"/></title>
<style>
body { font: 14px system-ui, sans-serif; margin: 2em; }
table { border-collapse: collapse; }
th, td { border: 1px solid #ccc; padding: 3px 10px; text-align: right; }
td.n { text-align: left; }
</style></head><body>
<h1><xsl:value-of select="title"/></h1>
<p>total <xsl:value-of select="totaltime"/> s</p>
<table><tr><th>stage</th><th>time s</th><th>calls</th><th>%</th></tr>
<xsl:apply-templates select="event"/>
</table></body></html>
</xsl:template>
<xsl:template match="event">
<tr>
<td class="n"><xsl:attribute name="style">padding-left: <xsl:value-of
  select="count(ancestor::event)*18 + 10"/>px</xsl:attribute>
<xsl:value-of select="name"/></td>
<td><xsl:value-of select="time"/></td>
<td><xsl:value-of select="ncalls"/></td>
<td><xsl:value-of select="percent"/></td>
</tr>
<xsl:apply-templates select="events/event"/>
</xsl:template>
</xsl:stylesheet>
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="report")
    p.add_argument("jsonl", help="bulk-run JSONL log")
    p.add_argument("-o", "--out", default="report.html")
    p.add_argument("--title", default="bulk run report")
    args = p.parse_args(argv)
    records = []
    with open(args.jsonl) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    with open(args.out, "w") as f:
        f.write(render(records, args.title))
    print(f"wrote {args.out} ({len(records)} runs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
