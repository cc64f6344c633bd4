"""``pydcop generate``: benchmark problem generators.

Ported copy of ``pydcop_tpu/commands/generate.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generate.py — subcommands
graph_coloring, ising, meetings, secp, agents, scenario, iot,
small_world with the reference's argument names, plus an added --seed on
every generator (deterministic output).
"""

import sys


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "generate", help="generate random problems")
    gen_sub = parser.add_subparsers(
        title="problems", dest="problem",
        description="type of problem to generate")
    parser.set_defaults(func=lambda args: (parser.print_help(), 2)[1])

    p = gen_sub.add_parser(
        "graph_coloring", help="graph coloring benchmark")
    p.add_argument("-v", "--variables_count", type=int, required=True)
    p.add_argument("-c", "--colors_count", type=int, required=True)
    p.add_argument("-g", "--graph", required=True,
                   choices=["random", "grid", "scalefree"])
    p.add_argument("--allow_subgraph", action="store_true")
    p.add_argument("--soft", action="store_true")
    p.add_argument("--intentional", action="store_true")
    p.add_argument("--noagents", action="store_true")
    p.add_argument("-p", "--p_edge", type=float, default=None)
    p.add_argument("-m", "--m_edge", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(func=_gen_graph_coloring)

    p = gen_sub.add_parser("ising", help="ising benchmark")
    p.add_argument("--row_count", type=int, required=True)
    p.add_argument("--col_count", type=int, default=None)
    p.add_argument("--bin_range", type=float, default=1.6)
    p.add_argument("--un_range", type=float, default=0.05)
    p.add_argument("--intentional", action="store_true")
    p.add_argument("--no_agents", action="store_true")
    p.add_argument("--fg_dist", action="store_true")
    p.add_argument("--var_dist", action="store_true")
    p.add_argument("--dist_dir", default=".",
                   help="directory for distribution files")
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(func=_gen_ising)

    p = gen_sub.add_parser(
        "meetings", help="meeting scheduling benchmark (PEAV)")
    p.add_argument("--slots_count", type=int, required=True)
    p.add_argument("--events_count", type=int, required=True)
    p.add_argument("--resources_count", type=int, required=True)
    p.add_argument("--max_resources_event", type=int, required=True)
    p.add_argument("--max_length_event", type=int, default=1)
    p.add_argument("--max_resource_value", type=int, default=10)
    p.add_argument("--no_agents", action="store_true")
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(func=_gen_meetings)

    p = gen_sub.add_parser("secp", help="smart-lighting SECP")
    p.add_argument("-l", "--lights", type=int, required=True)
    p.add_argument("-m", "--models", type=int, required=True)
    p.add_argument("-r", "--rules", type=int, required=True)
    p.add_argument("-c", "--capacity", type=int, default=None)
    p.add_argument("--max_model_size", type=int, default=3)
    p.add_argument("--max_rule_size", type=int, default=3)
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(func=_gen_secp)

    p = gen_sub.add_parser("agents", help="agent definitions")
    p.add_argument("--mode", required=True,
                   choices=["variables", "count"])
    p.add_argument("--dcop_files", type=str, nargs="+", default=None)
    p.add_argument("--count", type=int, default=None)
    p.add_argument("--agent_prefix", type=str, default="a")
    p.add_argument("--capacity", type=int, required=True)
    p.add_argument("--hosting", default="None",
                   choices=["None", "name_mapping", "var_startswith"])
    p.add_argument("--hosting_default", type=int, default=None)
    p.add_argument("--routes", default="None",
                   choices=["None", "uniform", "graph"])
    p.add_argument("--routes_default", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("dcop_files_end", type=str, nargs="*", default=None)
    p.set_defaults(func=_gen_agents)

    p = gen_sub.add_parser("scenario", help="dynamic DCOP scenario")
    p.add_argument("--evts_count", type=int, required=True)
    p.add_argument("--actions_count", type=int, required=True)
    p.add_argument("--delay", type=float, required=True)
    p.add_argument("--initial_delay", type=float, default=20)
    p.add_argument("--end_delay", type=float, default=20)
    p.add_argument("--dcop_files", type=str, nargs="+", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("dcop_files_end", type=str, nargs="*", default=None)
    p.set_defaults(func=_gen_scenario)

    p = gen_sub.add_parser("iot", help="IoT benchmark (scale-free)")
    p.add_argument("-n", "--num_devices", type=int, required=True)
    p.add_argument("-d", "--domain_size", type=int, default=3)
    p.add_argument("-m", "--m_edge", type=int, default=2)
    p.add_argument("-r", "--range_cost", type=int, default=10)
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(func=_gen_iot)

    p = gen_sub.add_parser(
        "small_world", help="small-world benchmark")
    p.add_argument("-n", "--num_variables", type=int, required=True)
    p.add_argument("-d", "--domain_range", type=int, default=10)
    p.add_argument("-k", "--degree", type=int, default=4)
    p.add_argument("-p", "--p_rewire", type=float, default=0.1)
    p.add_argument("-r", "--range_cost", type=int, default=10)
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(func=_gen_small_world)


def _output(args, text: str) -> int:
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def _gen_graph_coloring(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.generators.graphcoloring import (
        generate_graph_coloring,
    )

    dcop = generate_graph_coloring(
        args.variables_count, args.colors_count, args.graph,
        soft=args.soft, intentional=args.intentional,
        p_edge=args.p_edge, m_edge=args.m_edge,
        allow_subgraph=args.allow_subgraph, noagents=args.noagents,
        seed=args.seed,
    )
    return _output(args, dcop_yaml(dcop))


def _gen_ising(args) -> int:
    import os

    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, yaml_dist
    from pydcop_tpu_torch.distribution.objects import Distribution
    from pydcop_tpu_torch.generators.ising import generate_ising

    dcop, var_mapping, fg_mapping = generate_ising(
        args.row_count, args.col_count, args.bin_range, args.un_range,
        extensive=not args.intentional, no_agents=args.no_agents,
        fg_dist=args.fg_dist, var_dist=args.var_dist, seed=args.seed,
    )
    if var_mapping:
        path = os.path.join(args.dist_dir, f"{dcop.name}_vardist.yaml")
        with open(path, "w", encoding="utf-8") as f:
            f.write(yaml_dist(Distribution(var_mapping)))
    if fg_mapping:
        path = os.path.join(args.dist_dir, f"{dcop.name}_fgdist.yaml")
        with open(path, "w", encoding="utf-8") as f:
            f.write(yaml_dist(Distribution(fg_mapping)))
    return _output(args, dcop_yaml(dcop))


def _gen_meetings(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.generators.meetingscheduling import generate_meetings

    dcop = generate_meetings(
        args.slots_count, args.events_count, args.resources_count,
        args.max_resources_event, args.max_length_event,
        args.max_resource_value, no_agents=args.no_agents,
        capacity=args.capacity, seed=args.seed,
    )
    return _output(args, dcop_yaml(dcop))


def _gen_secp(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.generators.secp import generate_secp

    dcop = generate_secp(
        args.lights, args.models, args.rules, capacity=args.capacity,
        max_model_size=args.max_model_size,
        max_rule_size=args.max_rule_size, seed=args.seed,
    )
    return _output(args, dcop_yaml(dcop))


def _gen_agents(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import yaml_agents
    from pydcop_tpu_torch.generators.agents_gen import generate_agents

    dcop_files = args.dcop_files or args.dcop_files_end
    variables, adjacency = None, None
    if dcop_files:
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

        dcop = load_dcop_from_file(dcop_files)
        variables = list(dcop.variables)
        adjacency = [
            (a, b)
            for c in dcop.constraints.values()
            for i, a in enumerate(c.scope_names)
            for b in c.scope_names[i + 1:]
        ]
    agents = generate_agents(
        mode=args.mode, count=args.count, variables=variables,
        agent_prefix=args.agent_prefix, capacity=args.capacity,
        hosting=args.hosting, hosting_default=args.hosting_default,
        routes=args.routes, routes_default=args.routes_default,
        adjacency=adjacency, seed=args.seed,
    )
    return _output(args, yaml_agents(agents))


def _gen_scenario(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import (
        load_dcop_from_file,
        yaml_scenario,
    )
    from pydcop_tpu_torch.generators.scenario_gen import generate_scenario

    dcop_files = args.dcop_files or args.dcop_files_end
    if not dcop_files:
        print("Error: scenario generation requires dcop file(s)")
        return 2
    dcop = load_dcop_from_file(dcop_files)
    scenario = generate_scenario(
        args.evts_count, args.actions_count, args.delay,
        list(dcop.agents), initial_delay=args.initial_delay,
        end_delay=args.end_delay, seed=args.seed,
    )
    return _output(args, yaml_scenario(scenario))


def _gen_iot(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.generators.iot import generate_iot

    dcop = generate_iot(
        args.num_devices, args.domain_size, args.m_edge,
        args.range_cost, seed=args.seed,
    )
    return _output(args, dcop_yaml(dcop))


def _gen_small_world(args) -> int:
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.generators.smallworld import generate_small_world

    dcop = generate_small_world(
        args.num_variables, args.domain_range, args.degree,
        args.p_rewire, args.range_cost, seed=args.seed,
    )
    return _output(args, dcop_yaml(dcop))
