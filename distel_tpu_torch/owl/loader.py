"""Format detection and loading.  The port reads OWL functional syntax
(OFN) only; OWL/XML and RDF/XML documents are refused with a clear
error rather than misparsed."""

from __future__ import annotations

from distel_tpu_torch.owl import parser
from distel_tpu_torch.owl import syntax as S


def detect_format(text: str) -> str:
    """'ofn' | 'xml' by content sniffing: OWL/XML and RDF/XML documents
    both start with ``<``."""
    head = text.lstrip("﻿ \t\r\n")[:64]
    return "xml" if head.startswith("<") else "ofn"


def load(text: str) -> S.Ontology:
    if detect_format(text) != "ofn":
        raise ValueError(
            "XML input (OWL/XML, RDF/XML) is not supported by "
            "distel_tpu_torch yet: convert the ontology to OWL "
            "functional syntax"
        )
    return parser.parse(text)

