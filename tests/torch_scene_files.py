"""Small scene files for the importer tests of the port: the synthetic
files ``tests/test_utils.py`` writes for the JAX package's importers (the
same bytes), gathered as writers that take a directory and return the
file's path, and a binary FBX writer with the camera variants the port
refuses (a parent, PreRotation, RotationOrder)."""

import struct
import zlib

import numpy as np


def obj_with_mtl(d):
    (d / "scene.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\n"
        "newmtl lamp\nKd 0.7 0.7 0.7\nKe 1 1 1\nNs 20\n"
        "newmtl glass_thing\nKd 0.9 0.9 0.9\nNi 1.45\nd 0.2\n"
        "newmtl mirror\nKd 1 1 1\nillum 5\n"
    )
    obj = d / "scene.obj"
    obj.write_text(
        "mtllib scene.mtl\n"
        "v 0 0 -5\nv 1 0 -5\nv 1 1 -5\nv 0 1 -5\n"
        "vn 0 0 1\n"
        "usemtl red\nf 1//1 2//1 3//1 4//1\n"
        "usemtl lamp\nf -4 -3 -2\n"
        "usemtl glass_thing\nf 1 2 3\n"
        "usemtl mirror\nf 1 3 4\n"
    )
    return obj


def ply_ascii(d):
    p = d / "quad.ply"
    p.write_text(
        "ply\nformat ascii 1.0\ncomment a quad\n"
        "element vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 -5 0 0 1\n1 0 -5 0 0 1\n1 1 -5 0 0 1\n0 1 -5 0 0 1\n"
        "4 0 1 2 3\n"
    )
    return p


def ply_binary(d):
    p = d / "tri.ply"
    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 3\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 1\n"
        b"property list uchar int vertex_indices\n"
        b"end_header\n"
    )
    verts = np.asarray([[0, 0, -5], [1, 0, -5], [0, 1, -5]], "<f4")
    p.write_bytes(header + verts.tobytes() + struct.pack("<B3i", 3, 0, 1, 2))
    return p


def stl_binary(d):
    tri1 = [[0, 0, -5], [1, 0, -5], [1, 1, -5]]
    tri2 = [[0, 0, -5], [1, 1, -5], [0, 1, -5]]
    rec = b""
    for tri in (tri1, tri2):
        rec += struct.pack("<3f", 0, 0, 1)
        for v in tri:
            rec += struct.pack("<3f", *v)
        rec += struct.pack("<H", 0)
    p = d / "mesh.stl"
    p.write_bytes(b"\x00" * 80 + struct.pack("<I", 2) + rec)
    return p


def stl_ascii(d):
    p = d / "mesh_a.stl"
    p.write_text(
        "solid a\nfacet normal 0 0 1\nouter loop\n"
        "vertex 0 0 -5\nvertex 1 0 -5\nvertex 1 1 -5\n"
        "endloop\nendfacet\nendsolid a\n"
    )
    return p


def off(d):
    p = d / "quad.off"
    p.write_text(
        "OFF\n# a quad and a tri; faces carry trailing colours\n4 2 0\n"
        "0 0 -5\n1 0 -5\n1 1 -5\n0 1 -5\n"
        "4 0 1 2 3 255 0 0\n3 0 2 3 0.2 0.8 0.2 1.0\n"
    )
    return p


def fbx_binary_bytes(version=7400, camera=False, cam_props=(),
                     cam_parent=None):
    """``tests/test_utils.py:_fbx_binary_bytes``, plus: ``cam_props``,
    extra camera Properties70 entries as (name, type, values), and
    ``cam_parent``, the id of a Model the camera is connected to as its
    parent (None: no such connection, as there)."""
    big = version >= 7500

    def S(s):
        b = s.encode()
        return b"S" + struct.pack("<I", len(b)) + b

    def L(v):
        return b"L" + struct.pack("<q", v)

    def D(v):
        return b"D" + struct.pack("<d", v)

    def I(v):  # noqa: E743
        return b"I" + struct.pack("<i", v)

    def darr(vals, compress=False):
        raw = np.asarray(vals, "<f8").tobytes()
        if compress:
            comp = zlib.compress(raw)
            return b"d" + struct.pack("<III", len(vals), 1, len(comp)) + comp
        return b"d" + struct.pack("<III", len(vals), 0, len(raw)) + raw

    def iarr(vals):
        raw = np.asarray(vals, "<i4").tobytes()
        return b"i" + struct.pack("<III", len(vals), 0, len(raw)) + raw

    def node(name, props, children=()):
        return (name, props, children)

    hdr_fmt, hdr_n, null_n = ("<QQQ", 24, 25) if big else ("<III", 12, 13)

    def ser(n, start):
        name = n[0].encode()
        props = b"".join(n[1])
        header = hdr_n + 1 + len(name)
        pos = start + header + len(props)
        kid_bytes = b""
        if n[2]:
            for k in n[2]:
                kb = ser(k, pos)
                kid_bytes += kb
                pos += len(kb)
            kid_bytes += b"\x00" * null_n
            pos += null_n
        return (struct.pack(hdr_fmt, pos, len(n[1]), len(props))
                + bytes([len(name)]) + name + props + kid_bytes)

    def extra(name, kind, vals):
        if kind == "enum":
            return node("P", [S(name), S("enum"), S(""), S("")]
                        + [I(int(v)) for v in vals])
        return node("P", [S(name), S(kind), S(""), S("A")]
                    + [D(float(v)) for v in vals])

    cam_objects = [
        node("Model", [L(400), S("Model::Cam\x00\x01Model"), S("Camera")], [
            node("Properties70", [], [
                node("P", [S("Lcl Translation"), S("Lcl Translation"),
                           S(""), S("A"), D(2.5), D(0.5), D(5.0)]),
                node("P", [S("Lcl Rotation"), S("Lcl Rotation"),
                           S(""), S("A"), D(0.0), D(90.0), D(0.0)]),
            ] + [extra(*p) for p in cam_props]),
        ]),
        node("NodeAttribute",
             [L(500), S("NodeAttribute::Cam\x00\x01NodeAttribute"),
              S("Camera")], [
            node("Properties70", [], [
                node("P", [S("FieldOfView"), S("FieldOfView"), S(""),
                           S("A"), D(10.0)]),
            ]),
        ]),
    ] if camera else []
    cam_conns = ([node("C", [S("OO"), L(500), L(400)])] if camera else [])
    if camera and cam_parent is not None:
        cam_conns.append(node("C", [S("OO"), L(400), L(cam_parent)]))

    verts = [0, 0, -5, 1, 0, -5, 1, 1, -5, 0, 1, -5]
    tree = [
        node("Objects", [], [
            node("Geometry", [L(100), S("Geometry::Quad\x00\x01Geometry"),
                              S("Mesh")], [
                node("Vertices", [darr(verts, compress=True)]),
                node("PolygonVertexIndex", [iarr([0, 1, 2, -4])]),
            ]),
            node("Model", [L(200), S("Model::Quad\x00\x01Model"),
                           S("Mesh")], [
                node("Properties70", [], [
                    node("P", [S("Lcl Translation"), S("Lcl Translation"),
                               S(""), S("A"), D(2.0), D(0.0), D(-1.0)]),
                ]),
            ]),
            node("Material", [L(300), S("Material::Red\x00\x01Material"),
                              S("")], [
                node("Properties70", [], [
                    node("P", [S("DiffuseColor"), S("Color"), S(""),
                               S("A"), D(0.8), D(0.1), D(0.1)]),
                ]),
            ]),
        ] + cam_objects),
        node("Connections", [], [
            node("C", [S("OO"), L(100), L(200)]),
            node("C", [S("OO"), L(300), L(200)]),
        ] + cam_conns),
    ]
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", version)
    pos = len(out)
    for n in tree:
        b = ser(n, pos)
        out += b
        pos += len(b)
    out += b"\x00" * null_n
    return out


def fbx_binary(d, version=7400, camera=False, **kw):
    p = d / f"quad{version}{'_cam' if camera else ''}.fbx"
    p.write_bytes(fbx_binary_bytes(version, camera, **kw))
    return p


def fbx_ascii(d):
    p = d / "quad_ascii.fbx"
    p.write_text(
        '; FBX 7.4.0 project file\n'
        'Objects:  {\n'
        '\tGeometry: 100, "Geometry::Quad", "Mesh" {\n'
        '\t\tVertices: *12 {\n'
        '\t\t\ta: 0,0,-5,1,0,-5,1,1,\n'
        '\t\t\t-5,0,1,-5\n'
        '\t\t}\n'
        '\t\tPolygonVertexIndex: *4 {\n'
        '\t\t\ta: 0,1,2,-4\n'
        '\t\t}\n'
        '\t}\n'
        '\tModel: 200, "Model::Quad", "Mesh" {\n'
        '\t}\n'
        '\tMaterial: 300, "Material::Green", "" {\n'
        '\t\tProperties70:  {\n'
        '\t\t\tP: "DiffuseColor", "Color", "", "A",0.1,0.9,0.2\n'
        '\t\t}\n'
        '\t}\n'
        '}\n'
        'Connections:  {\n'
        '\tC: "OO",100,200\n'
        '\tC: "OO",300,200\n'
        '}\n'
    )
    return p


def fbx_ascii_camera(d, cam_extra="", parent_conn=""):
    p = d / "cam_ascii.fbx"
    p.write_text(
        'Objects:  {\n'
        '\tGeometry: 100, "Geometry::Quad", "Mesh" {\n'
        '\t\tVertices: *12 {\n'
        '\t\t\ta: 0,0,-5,1,0,-5,1,1,-5,0,1,-5\n'
        '\t\t}\n'
        '\t\tPolygonVertexIndex: *4 {\n'
        '\t\t\ta: 0,1,2,-4\n'
        '\t\t}\n'
        '\t}\n'
        '\tModel: 200, "Model::Quad", "Mesh" {\n'
        '\t}\n'
        '\tModel: 400, "Model::Cam", "Camera" {\n'
        '\t\tProperties70:  {\n'
        '\t\t\tP: "Lcl Translation", "Lcl Translation", "", "A",0.5,0.5,5.0\n'
        '\t\t\tP: "Lcl Rotation", "Lcl Rotation", "", "A",0.0,90.0,0.0\n'
        '\t\t\tP: "FieldOfView", "FieldOfView", "", "A",10.0\n'
        + cam_extra +
        '\t\t}\n'
        '\t}\n'
        '}\n'
        'Connections:  {\n'
        '\tC: "OO",100,200\n'
        + parent_conn +
        '}\n'
    )
    return p


def fbx_v6(d, camera=False, parent="Model::Scene"):
    """FBX 6.x value lists; with ``camera`` a camera Model connected by
    name to ``parent``."""
    p = d / "six.fbx"
    cam = ('\tModel: "Model::Cam", "Camera" {\n'
           '\t\tProperties60:  {\n'
           '\t\t\tProperty: "Lcl Translation", "Lcl Translation", "A",0.5,0.5,5.0\n'
           '\t\t}\n'
           '\t}\n') if camera else ""
    conns = ('Connections:  {\n'
             f'\tConnect: "OO", "Model::Cam", "{parent}"\n'
             '}\n') if camera else ""
    p.write_text(
        'Objects:  {\n'
        '\tModel: "Model::Quad", "Mesh" {\n'
        '\t\tVertices: 0,0,-5,1,0,-5,1,1,-5,0,1,-5\n'
        '\t\tPolygonVertexIndex: 0,1,2,-4\n'
        '\t}\n'
        + cam +
        '}\n' + conns
    )
    return p
