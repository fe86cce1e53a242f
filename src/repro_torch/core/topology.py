"""Topology generation for the simulation study (paper §V-C).

The paper generated 50 NetworkX topologies "that resemble autonomous systems
on the Internet" [35], each 20–40 nodes, 10 random ENs, 5 ms core links,
users attached via 2 ms links.  ``paper_topology`` reproduces that setup;
``testbed_topology`` reproduces the 6-box real-world testbed (Fig. 7): two
users, two forwarders, two ENs, with an 18 ms average user<->EN RTT.
"""
from __future__ import annotations

import random
from typing import List, Tuple

import networkx as nx


def paper_topology(seed: int = 0, n_nodes: int = None, n_ens: int = 10,
                   link_delay_s: float = 0.005) -> Tuple[nx.Graph, List[int]]:
    rng = random.Random(seed)
    n = n_nodes or rng.randint(20, 40)
    # AS-like: preferential attachment gives the heavy-tailed degree
    # distribution of inter-AS graphs [35].
    g = nx.barabasi_albert_graph(n, 2, seed=seed)
    for a, b in g.edges:
        g.edges[a, b]["delay"] = link_delay_s
    ens = rng.sample(sorted(g.nodes), min(n_ens, n))
    return g, ens


def testbed_topology(link_delay_s: float = 0.004) -> Tuple[nx.Graph, List[str]]:
    """Fig. 7: users -- fwd1 -- fwd2 -- {EN1, EN2} (UDP-tunnel overlay).

    With 2 ms user links and ~4 ms overlay hops the user->EN RTT lands in the
    paper's measured 13-21 ms range once forwarder processing is charged.
    """
    g = nx.Graph()
    for a, b in [("fwd1", "fwd2"), ("fwd2", "en1"), ("fwd2", "en2"), ("fwd1", "en1")]:
        g.add_edge(a, b, delay=link_delay_s)
    return g, ["en1", "en2"]


def line_topology(n_hops: int = 3, link_delay_s: float = 0.005):
    g = nx.path_graph(n_hops + 1)
    for a, b in g.edges:
        g.edges[a, b]["delay"] = link_delay_s
    return g, [n_hops]
