"""HTML main-content extraction — parity with the reference's scraper cascade.

Copy of the JAX package's `symbiont_tpu/services/html_extract.py`.

Reference (services/perception_service/src/main.rs:86-170):
1. find the first element matching, in order: article, main, div[role='main'],
   div.content, div.post-content, div.entry-content, body — else whole doc;
2. within it, for each of h1..h6, p, li, span in that order, collect each
   element's text nodes (trimmed, space-joined), skipping empties;
3. join parts with newlines, trim lines, drop empty lines.

Implemented on the stdlib html.parser (no external scraper dependency): a tiny
DOM with just enough selector support for the cascade above.
"""

from __future__ import annotations

from html.parser import HTMLParser
from typing import List, Optional

VOID_ELEMENTS = {
    "area", "base", "br", "col", "embed", "hr", "img", "input", "link",
    "meta", "param", "source", "track", "wbr",
}

SKIP_TEXT_IN = {"script", "style", "noscript", "template"}

CONTENT_SELECTORS = [
    "article", "main", "div[role='main']", "div.content",
    "div.post-content", "div.entry-content", "body",
]

TEXT_SELECTORS = ["h1", "h2", "h3", "h4", "h5", "h6", "p", "li", "span"]


class Node:
    __slots__ = ("tag", "attrs", "children", "parent")

    def __init__(self, tag: str, attrs: Optional[dict] = None, parent=None):
        self.tag = tag
        self.attrs = attrs or {}
        self.children: list = []  # Node or str (text)
        self.parent = parent


class _DomBuilder(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.root = Node("#document")
        self.stack = [self.root]

    def handle_starttag(self, tag, attrs):
        node = Node(tag, dict(attrs), parent=self.stack[-1])
        self.stack[-1].children.append(node)
        if tag not in VOID_ELEMENTS:
            self.stack.append(node)

    def handle_startendtag(self, tag, attrs):
        self.stack[-1].children.append(Node(tag, dict(attrs), parent=self.stack[-1]))

    def handle_endtag(self, tag):
        # close the nearest matching open tag (tolerant of malformed HTML)
        for i in range(len(self.stack) - 1, 0, -1):
            if self.stack[i].tag == tag:
                del self.stack[i:]
                break

    def handle_data(self, data):
        if data:
            self.stack[-1].children.append(data)


def parse_html(html: str) -> Node:
    b = _DomBuilder()
    b.feed(html)
    b.close()
    return b.root


def _matches(node: Node, selector: str) -> bool:
    if "[" in selector:  # tag[attr='value']
        tag, rest = selector.split("[", 1)
        attr, value = rest.rstrip("]").split("=", 1)
        value = value.strip("'\"")
        return node.tag == tag and node.attrs.get(attr) == value
    if "." in selector:  # tag.class
        tag, cls = selector.split(".", 1)
        classes = (node.attrs.get("class") or "").split()
        return node.tag == tag and cls in classes
    return node.tag == selector


def _walk(node: Node):
    for child in node.children:
        if isinstance(child, Node):
            yield child
            yield from _walk(child)


def find_first(root: Node, selector: str) -> Optional[Node]:
    for node in _walk(root):
        if _matches(node, selector):
            return node
    return None


def select_all(root: Node, selector: str) -> List[Node]:
    return [n for n in _walk(root) if _matches(n, selector)]


def _text_nodes(node: Node):
    if node.tag in SKIP_TEXT_IN:
        return
    for child in node.children:
        if isinstance(child, str):
            yield child
        else:
            yield from _text_nodes(child)


def element_text(node: Node) -> str:
    """Trimmed text nodes joined with single spaces (main.rs:133-142)."""
    parts = [t.strip() for t in _text_nodes(node)]
    return " ".join(p for p in parts if p)


def extract_main_text(html: str) -> str:
    """Full cascade (main.rs:100-160)."""
    doc = parse_html(html)
    scope = None
    for sel in CONTENT_SELECTORS:
        scope = find_first(doc, sel)
        if scope is not None:
            break
    if scope is None:
        scope = doc
    parts: List[str] = []
    for sel in TEXT_SELECTORS:
        for el in select_all(scope, sel):
            text = element_text(el)
            if text:
                parts.append(text)
    lines = [ln.strip() for ln in "\n".join(parts).split("\n")]
    return "\n".join(ln for ln in lines if ln)
