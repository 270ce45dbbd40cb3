"""OWL 2 EL frontend: AST, functional-syntax parser, serializer."""
