"""Format auto-detection — the OWLAPI ``OWLManager.loadOntology`` analog
(reference ``init/AxiomLoader.java:127-136``): one entry point that sniffs
functional syntax, RDF/XML, or OWL/XML and dispatches to the right reader.
"""

from __future__ import annotations

import re
from xml.etree import ElementTree

from distel_tpu_torch.owl import owlxml, parser, rdfxml
from distel_tpu_torch.owl import syntax as S

_ROOT_ELEM_RE = re.compile(r"<([A-Za-z_][\w.-]*:)?([A-Za-z_][\w.-]*)")


def _root_element_local(text: str) -> str | None:
    """Local name of the document's root element, skipping the XML
    preamble (declaration, comments, doctype) *as regions* — a naive
    scan mistakes element-like text inside a comment for the root."""
    head = text.lstrip("﻿ \t\r\n")[:4096]
    pos = 0
    while pos < len(head):
        if head.startswith("<?", pos):
            end = head.find("?>", pos)
            if end < 0:
                return None
            pos = end + 2
        elif head.startswith("<!--", pos):
            end = head.find("-->", pos)
            if end < 0:
                return None
            pos = end + 3
        elif head.startswith("<!", pos):
            end = head.find(">", pos)
            if end < 0:
                return None
            pos = end + 1
        elif head.startswith("<", pos):
            m = _ROOT_ELEM_RE.match(head, pos)
            return m.group(2) if m else None
        else:
            nxt = head.find("<", pos)
            if nxt < 0:
                return None
            pos = nxt
    return None


def detect_format(text: str) -> str:
    """'ofn' | 'rdfxml' | 'owlxml' by content sniffing.  XML documents are
    routed by their *root element* (an OWL/XML file routinely declares
    xmlns:rdf too, so substring checks misfire)."""
    head = text.lstrip("﻿ \t\r\n")[:4096]
    if head.startswith("<"):
        local = _root_element_local(text)
        return "owlxml" if local == "Ontology" else "rdfxml"
    return "ofn"


def _rdf_rooted(text: str) -> bool:
    """First element of the document is (rdf:)RDF — a full RDF/XML
    document, never a fragment to envelope."""
    return _root_element_local(text) == "RDF"


def load(text: str) -> S.Ontology:
    fmt = detect_format(text)
    if fmt == "rdfxml":
        try:
            return rdfxml.parse(text)
        except ElementTree.ParseError as err:
            # Headerless fragment — the reference's streamed traffic
            # files, which it envelopes with HeaderFooterAdder.java
            # before loading.  Fragments announce themselves as either
            # "junk after document element" (multiple roots) or
            # "unbound prefix" (the envelope carried the declarations);
            # a document already rooted at rdf:RDF is never a fragment.
            # Anything else re-raises with the coordinates of the
            # document the user wrote.
            fragment_shaped = (
                "junk after document element" in str(err)
                or "unbound prefix" in str(err)
            ) and not _rdf_rooted(text)
            if not fragment_shaped:
                raise
            try:
                return rdfxml.parse(rdfxml.wrap_fragment(text))
            except ElementTree.ParseError as err2:
                if "unbound prefix" in str(err2):
                    raise ValueError(
                        "RDF/XML fragment uses namespace prefixes beyond "
                        "rdf/rdfs/owl — envelope it explicitly with "
                        "rdfxml.wrap_fragment(text, extra_namespaces=...)"
                    ) from err2
                raise err from None  # original coordinates
    if fmt == "owlxml":
        return owlxml.parse(text)
    return parser.parse(text)


def load_file(path: str) -> S.Ontology:
    # utf-8-sig: tolerate BOMs from Windows exports
    with open(path, "r", encoding="utf-8-sig") as f:
        return load(f.read())
