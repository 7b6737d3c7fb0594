"""Minimal standalone-HTML report writer.

Ref parity: nvbio/basic/html.h — the reference renders nvBowtie run
stats and aln-diff comparisons as HTML tables; this module reproduces
that with dependency-free generated pages (tables + CSS bar charts).

A copy of ``nvbio_tpu/utils/html.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import html as _html

_CSS = """
body { font-family: sans-serif; margin: 2em; color: #222; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 1.5em; }
table { border-collapse: collapse; margin: 0.5em 0; }
td, th { border: 1px solid #ccc; padding: 4px 10px; text-align: right; }
th { background: #f0f0f0; }
td:first-child, th:first-child { text-align: left; }
.bar { background: #4a90d9; height: 12px; display: inline-block; }
.barbg { background: #eee; width: 240px; display: inline-block; }
"""


def _esc(x):
    return _html.escape(str(x))


def table(rows, header=None) -> str:
    out = ["<table>"]
    if header:
        out.append("<tr>" + "".join(f"<th>{_esc(h)}</th>" for h in header)
                   + "</tr>")
    for row in rows:
        out.append("<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in row)
                   + "</tr>")
    out.append("</table>")
    return "\n".join(out)


def bar_chart(items, unit="") -> str:
    """items: [(label, value)] -> labeled horizontal CSS bars."""
    items = list(items)
    mx = max((v for _, v in items), default=0) or 1
    rows = []
    for label, v in items:
        w = int(240 * v / mx)
        rows.append(
            f"<tr><td>{_esc(label)}</td>"
            f"<td><span class='barbg'><span class='bar' "
            f"style='width:{w}px'></span></span></td>"
            f"<td>{_esc(round(v, 4))}{_esc(unit)}</td></tr>"
        )
    return "<table>" + "\n".join(rows) + "</table>"


def page(title: str, sections) -> str:
    """sections: [(heading, html_fragment)] -> full document."""
    body = "\n".join(
        f"<h2>{_esc(h)}</h2>\n{frag}" for h, frag in sections
    )
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
        f"<body><h1>{_esc(title)}</h1>\n{body}\n</body></html>"
    )
