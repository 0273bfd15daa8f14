from .graphs import random_labeled_graph
from .queries import (query_from_template, random_query_from_graph,
                      template_queries)

__all__ = ["random_labeled_graph", "template_queries",
           "query_from_template", "random_query_from_graph"]
